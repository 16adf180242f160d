// K1/K2 and K4 at every latent dimension past the whole-K tiles of
// csrc/fused_poisson.cu (K1/K2: padded K > 124, K4: > 152). They replace the
// same TPU kernels (spmf_tpu/ops/fused_poisson.py::_stats_grad_kernel,
// ::_sum_static_grad_kernel and ::_row_ll_kernel), which put the whole
// latent dimension in one block and set no limit on it. The cells and the
// outputs are those of fused_poisson.cu; one block owns (row tile of TB =
// 128 rows, sample s) and loops over the column tiles of TD = 64. The decode
// tv = theta . v needs the whole of K before any cell can be scored, so a
// block walks K in chunks inside each column tile and never launches per
// chunk.
//
// K1/K2 run the three K-deep products (decode, dtheta, dv: 6 S B D K flops,
// 503 GFLOP at S=8, B=4096, D=20000, K=128) on the tensor cores in three
// split-TF32 passes, in csrc/split_tf32.cuh's design (K5's wide kernel is
// the same): to padded K = 128 theta, the tile's split v and dtheta stay on
// chip, past that the chunks stream and dtheta accumulates in device memory
// by its owner thread; dv by atomics. Their bound falls from 7.54 ms on the
// FP32 pipes to 3.05 ms (three passes at 494.7 TFLOP/s). One block an SM;
// the link and the clip are run-time flags (an instance per likelihood and
// per route, 10 in all, where the whole-K kernel has 20).
//
// K4 decodes on the FP32 pipes in chunks of KC = 28 latent dimensions: a
// chunk is theta's TB rows at KC latent dimensions, row-major [TB][KC], and
// the v tile's KC rows [KC][TP]; the ring holds two, and cp.async brings the
// next while the block computes on the current one. Per column tile: acc (8
// rows x 4 columns a thread, registers) += theta_c . v_c, k ascending as in
// the whole-K kernel; per 4 k one float4 of theta for each of the thread's 8
// rows and one of v for each k: 12 loads for 128 multiply-adds; then
// row_ll_cells from the registers, a double per row owned by one thread: the
// same bits on every launch. 111,232 bytes of dynamic shared memory (the
// ring, two stages of the x tile and the lanes, the table), whatever K: two
// blocks an SM, and __launch_bounds__(256, 2) holds it to 128 registers
// (chip_smoke.py fails on a spill).
#include "fused_poisson.cuh"

namespace {

static_assert(KC % KS == 0, "a chunk is whole k-steps");
static_assert((STAGE * 4) % 16 == 0 && (TB * KC * 4) % 16 == 0, "stages on 16 bytes");

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// chunk kc0 .. kc0 + kw - 1 into a stage: theta's rows r0.. (zeros past row
// B and past K) and v's rows at columns col0.. (zeros past K and past D)
__device__ __forceinline__ void load_chunk(float* stage, const CellArgs& a, int s, int r0,
                                           const float* __restrict__ v_smp, int kc0, int col0) {
  const int kw = min(KC, a.KP - kc0), nq = kw / 4;
  float* th = stage;
  float* vc = stage + TB * KC;
  for (int p = threadIdx.x; p < TB * nq; p += THREADS) {
    const int r = p / nq, q = p % nq, k = kc0 + 4 * q;
    float* dst = th + r * KC + 4 * q;
    if (r0 + r < a.B)
      load_group(dst, a.theta + ((size_t)s * a.B + r0 + r) * a.K + k, a.K - k, a.vec_theta);
    else
      st4(dst, 0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int p = threadIdx.x; p < kw * TX; p += THREADS) {
    const int j = p / TX, g = p % TX, k = kc0 + j, col = col0 + 4 * g;
    float* dst = vc + j * TP + 4 * g;
    if (k < a.K) load_group(dst, v_smp + (size_t)k * a.D + col, a.D - col, a.vec);
    else st4(dst, 0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// the eta, phi and codes lanes of columns col0.. into lane_s [NLANE][TD]
__device__ __forceinline__ void load_lanes(float* lane_s, const CellArgs& a,
                                           const float* __restrict__ phi_smp, int col0) {
  const int t = threadIdx.x;
  if (t < NLANE * TX) {
    const int row = t / TX, g = t % TX, col = col0 + 4 * g;
    const float* src = row == 0 ? a.eta : (row == 1 ? phi_smp : a.codes);
    load_group(lane_s + row * TD + 4 * g, src + col, a.D - col, a.vec);
  }
}

// acc[i][j] += theta[tile_row(ty, i)] . v[:, 4 tx + j] over the chunk's kw
// latent dimensions, k ascending
__device__ __forceinline__ void decode_chunk(const float* th, const float* vc, int kw, int tx,
                                             int ty, float (&acc)[RI][4]) {
  const float* b = vc + tx * 4;
  for (int k0 = 0; k0 < kw; k0 += KS) {
    float4 t[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) t[i] = ld4(th + tile_row(ty, i) * KC + k0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 w = ld4(b + (k0 + kk) * TP);
      const float vv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float th_k = comp(t[i], kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(th_k, vv[j], acc[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------- K1 / K2
// csrc/split_tf32.cuh's design (shared with K5's wide kernel): to padded K
// = 128 (N = 4 chunks) theta, the tile's split v and dtheta (in registers,
// written once) stay on chip; past that (N = 0) the chunks stream and
// dtheta accumulates in device memory by its owner thread. The three
// products run on the tensor cores in three TF32 passes; dv by float4
// atomics. The cells between decode and gradients are fused_poisson.cuh's,
// on the warp's C fragments: each thread stages its decode sums in its own
// cells of the G tile, whose lo half holds the tile's counts x until the
// split (requested at the tile's top, under the decode), scores its 32
// cells there and splits dtv once; the tile's d/d(phi) is summed over the
// warp's rows by shuffles into the warp's row, over the warps in a fixed
// order.
using tf32x3::W_G;
using tf32x3::W_GP;
using tf32x3::W_NRES;
using tf32x3::W_RES;

// the counts x of the warp's 16 rows of the block at columns col0 ..
// col0 + 63 into x_s [TB][GP] (rows rw ..), by the warp's own lanes (so a
// __syncwarp after the wait makes them the warp's); zeros past row B and D
__device__ __forceinline__ void load_x_rows(float* x_s, const float* __restrict__ x, int r0,
                                            int rw, int col0, int B, int D, bool vec) {
  for (int p = threadIdx.x & 31; p < 16 * TX; p += 32) {
    const int r = rw + p / TX, gi = p % TX, col = col0 + 4 * gi;
    float* dst = x_s + r * W_GP + 4 * gi;
    if (r0 + r < B) load_group(dst, x + (size_t)(r0 + r) * D + col, D - col, vec);
    else st4(dst, 0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// This thread's cells of the tile: rows rw + g and rw + g + 8 of the block,
// columns 8j + 2t and 8j + 2t + 1 for j = 0..7, their decode sums in t_s
// [TB][GP] (staged by this thread) and replaced there by dtv, their counts
// in x_s [TB][GP]; the clipped sum, count and minimum into lsum / lcnt /
// lmin, the warp's d/d(phi) of the tile into its row dphi_w [TD]. The
// per-cell arithmetic is stats_cells', the link (lg) and the clip (st)
// chosen at run time: a branch the whole block takes alike, where the
// whole-K kernel has an instance each. A rolled loop, as there, keeps the
// code small.
template <int LIK>
__device__ __forceinline__ void stats_cells_frag(const CellArgs& a, bool lg, bool st, float* t_s,
                                                 const float* x_s, const float* lane_s,
                                                 const float* tab_s, float* dphi_w, int r0,
                                                 int rw, int col0, double& lsum, int& lcnt,
                                                 float& lmin) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float tsum = 0.0f;  // this thread's 32 cells; the double sum takes it whole
#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 eta2 = *reinterpret_cast<const float2*>(lane_s + c);
    const float2 phi2 = *reinterpret_cast<const float2*>(lane_s + TD + c);
    const float2 code2 = *reinterpret_cast<const float2*>(lane_s + 2 * TD + c);
    float drs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rw + g + 8 * rr;
      const bool row_ok = r0 + r < a.B;
      float* tp = t_s + r * W_GP + c;
      const float2 tv2 = *reinterpret_cast<const float2*>(tp);
      const float2 x2 = *reinterpret_cast<const float2*>(x_s + r * W_GP + c);
      float dtv[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float tv = cc ? tv2.y : tv2.x, xv = cc ? x2.y : x2.x;
        const float eta = cc ? eta2.y : eta2.x, phi = cc ? phi2.y : phi2.x;
        const float code = cc ? code2.y : code2.x;
        const bool inb = row_ok && col0 + c + cc < a.D;
        float ev;
        const float rate = lg ? decode_rate<true>(tv, eta, phi, ev)
                              : decode_rate<false>(tv, eta, phi, ev);
        const float lgx = HAS_POISSON<LIK> ? lgamma_xp1(xv, tab_s) : 0.0f;
        float dll;
        const float ll = cell_ll<LIK>(xv, rate, code, a.inv_scale, a.norm_const, lgx, dll);
        const bool finite = fabsf(ll) <= FLT_MAX;  // false for inf and NaN
        const bool keep = finite && ll > FLOOR;
        const bool active = inb && keep && ll < 0.0f;
        const float drate = active ? dll : 0.0f;
        // mask after the product: padded cells must contribute exact zeros
        dtv[cc] = active ? drate * (lg ? ev * eta : eta) : 0.0f;
        drs[cc] += drate;
        if (inb) {
          if (st) {
            tsum += keep ? fminf(ll, 0.0f) : FLOOR;
          } else {
            if (finite) lmin = fminf(lmin, ll);
            if (keep) tsum += fminf(ll, 0.0f);
            else ++lcnt;
          }
        }
      }
      *reinterpret_cast<float2*>(tp) = make_float2(dtv[0], dtv[1]);
    }
    // d/d(phi) of the column pair over the warp's 16 rows: the 8 lanes of t
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      float d = drs[cc];
      d += __shfl_xor_sync(FULL, d, 4);
      d += __shfl_xor_sync(FULL, d, 8);
      d += __shfl_xor_sync(FULL, d, 16);
      if (g == 0) dphi_w[c + cc] = d;
    }
  }
  lsum += (double)tsum;
}

template <int N, int LIK>
__global__ void __launch_bounds__(THREADS, 1)
stats_wide_kernel(const CellArgs a, bool lg, bool st, double* __restrict__ psum,
                  int* __restrict__ pcnt, float* __restrict__ pmin, float* __restrict__ dtheta,
                  float* __restrict__ dv, float* __restrict__ dphi) {
  extern __shared__ __align__(16) float smem[];
  float* g_s = smem + W_RES - W_G;          // [TB][GP] hi, lo (lo: x before the split)
  float* x_s = g_s + TB * W_GP;
  float* lane_s = smem + W_RES;             // [NLANE][TD] eta, phi, codes
  float* dphi_w = lane_s + NLANE * TD;      // [WARPS][TD] each warp's d/d(phi)
  float* tab_s = dphi_w + (THREADS / 32) * TD;  // [TABLE_N]
  __shared__ double red_sum[THREADS / 32];
  __shared__ int red_cnt[THREADS / 32];
  __shared__ float red_min[THREADS / 32];

  const int K = a.K, B = a.B, D = a.D;
  const int s = blockIdx.x % a.S;           // samples of one row tile are adjacent
  const int r0 = (blockIdx.x / a.S) * TB;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int rw = warp * 16;                 // this warp's first row in the block
  const float* th_blk = a.theta + ((size_t)s * B + r0) * K;
  const float* v_smp = a.v + (size_t)s * K * D;
  const float* phi_smp = a.phi + (size_t)s * D;
  float* dv_smp = dv + (size_t)s * K * D;
  float* dth_row = dtheta + ((size_t)s * B + r0 + rw + g) * K;
  const bool row_ok = r0 + rw + g < B, row8_ok = r0 + rw + g + 8 < B;
  // the tile's d/d(phi) out to device memory, the warps' rows summed in a
  // fixed order (every warp's cells are done)
  const auto flush_dphi = [&](int col0) {
    if (tid < TX) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        const float4 e = ld4(dphi_w + w * TD + 4 * tid);
        d[0] += e.x, d[1] += e.y, d[2] += e.z, d[3] += e.w;
      }
      atomic_add4(dphi + (size_t)s * D, col0 + 4 * tid, D, a.vec, d[0], d[1], d[2], d[3]);
    }
  };
  // the cells of the warp's tile: T staged in its own cells of g_s, its
  // counts (requested into g_s's lo half) waited for, dtv back in T
  double lsum = 0.0;
  int lcnt = 0;
  float lmin = 0.0f;
  const auto cells = [&](int col0, float (&T)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = (rw + g) * W_GP + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(g_s + o) = make_float2(T[j][0], T[j][1]);
      *reinterpret_cast<float2*>(g_s + o + 8 * W_GP) = make_float2(T[j][2], T[j][3]);
    }
    cp_async_wait_all();
    __syncwarp();
    stats_cells_frag<LIK>(a, lg, st, g_s, x_s, lane_s, tab_s, dphi_w + warp * TD, r0, rw, col0,
                          lsum, lcnt, lmin);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = (rw + g) * W_GP + 8 * j + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(g_s + o);
      const float2 w = *reinterpret_cast<const float2*>(g_s + o + 8 * W_GP);
      T[j][0] = u.x, T[j][1] = u.y, T[j][2] = w.x, T[j][3] = w.y;
    }
  };

  load_lanes(lane_s, a, phi_smp, 0);
  if (HAS_POISSON<LIK> && tid < TABLE_N) tab_s[tid] = a.lgtab[tid];
  // the decode takes a fresh partial every k-step (split_tf32.cuh)
  const tf32x3::WideOperands ops{smem, th_blk, v_smp, dv_smp, dth_row, B - r0, K, D,
                                 a.vec, a.vec_theta, a.vec, row_ok, row8_ok};
  tf32x3::wide_products<N, 1>(
      ops, [&](int col0) { load_x_rows(x_s, a.x, r0, rw, col0, B, D, a.vec); }, cells,
      [&](int col1) { load_lanes(lane_s, a, phi_smp, col1); }, flush_dphi);

  // the block's partials of the per-sample statistics: psum, pcnt and pmin
  // at [sample][row tile], the sum in a fixed order
  lcnt = warp_sum(lcnt);
  lmin = warp_min(lmin);
  if ((tid & 31) == 0) {
    red_cnt[warp] = lcnt;
    red_min[warp] = lmin;
  }
  const double total = tf32x3::block_sum_fixed(lsum, red_sum);  // synchronises
  if (tid == 0) {
    const int out = s * (gridDim.x / a.S) + blockIdx.x / a.S;
    psum[out] = total;
    if (!st) {
      int cnt = 0;
      float mn = 0.0f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        cnt += red_cnt[w];
        mn = fminf(mn, red_min[w]);
      }
      pcnt[out] = cnt;
      pmin[out] = mn;
    }
  }
}

// ------------------------------------------------------------------ K4
template <int LIK, bool LOG>
__global__ void __launch_bounds__(THREADS, 2)
row_ll_wide_kernel(const CellArgs a, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int KP = a.KP, B = a.B, D = a.D;
  constexpr int XL = TB * TD + NLANE * TD;    // an x tile and its lanes
  float* ring = smem;                         // 2 x STAGE
  float* xl = ring + 2 * STAGE;               // 2 x XL
  float* tab_s = xl + 2 * XL;                 // [TABLE_N]
  __shared__ double row_sum[TB];              // one owner thread per row

  const int s = blockIdx.x % a.S;
  const int r0 = (blockIdx.x / a.S) * TB;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const float* v_smp = a.v + (size_t)s * a.K * D;
  const float* phi_smp = a.phi + (size_t)s * D;
  const int n = (KP + KC - 1) / KC;

  load_x_tile(xl, a.x, r0, 0, B, D, a.vec);
  load_lanes(xl + TB * TD, a, phi_smp, 0);
  load_chunk(ring, a, s, r0, v_smp, 0, 0);
  cp_async_commit();
  if (tid < TB) row_sum[tid] = 0.0;
  if (HAS_POISSON<LIK> && tid < TABLE_N) tab_s[tid] = a.lgtab[tid];

  int stage = 0, xst = 0;
  for (int col0 = 0; col0 < D; col0 += TD, xst ^= 1) {
    const bool more = col0 + TD < D;
    float acc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int q = 0; q < n; ++q, stage ^= 1) {
      cp_async_wait_all();
      __syncthreads();  // chunk q is in; the other stages' readers are done
      if (q == 0 && more) {  // the next tile's x and lanes land under this decode
        load_x_tile(xl + (xst ^ 1) * XL, a.x, r0, col0 + TD, B, D, a.vec);
        load_lanes(xl + (xst ^ 1) * XL + TB * TD, a, phi_smp, col0 + TD);
      }
      if (q + 1 < n) load_chunk(ring + (stage ^ 1) * STAGE, a, s, r0, v_smp, (q + 1) * KC, col0);
      else if (more) load_chunk(ring + (stage ^ 1) * STAGE, a, s, r0, v_smp, 0, col0 + TD);
      cp_async_commit();
      decode_chunk(ring + stage * STAGE, ring + stage * STAGE + TB * KC, min(KC, KP - q * KC), tx,
                   ty, acc);
    }
    const float* xt = xl + xst * XL;
    row_ll_cells<LIK, LOG>(a, acc, xt, xt + TB * TD, xt + TB * TD + TD, xt + TB * TD + 2 * TD,
                           tab_s, row_sum, r0, col0);
  }
  __syncthreads();
  if (tid < TB && r0 + tid < B) out[(size_t)s * B + r0 + tid] = (float)row_sum[tid];
}

// ------------------------------------------------------------ launches
template <int N, int LIK>
int launch_stats_wide(const CellArgs& a, bool lg, bool st, const StatsOut& o,
                      cudaStream_t stream) {
  const int smem = (int)sizeof(float) * stats_wide_smem_floats();
  const int err = prepare(stats_wide_kernel<N, LIK>, smem);
  if (err != 0) return err;
  const int blocks = a.S * ((a.B + TB - 1) / TB);
  stats_wide_kernel<N, LIK><<<blocks, THREADS, smem, stream>>>(a, lg, st, o.psum, o.pcnt, o.pmin,
                                                               o.dtheta, o.dv, o.dphi);
  return (int)cudaGetLastError();
}

// K1/K2 past their whole-K tiles (padded K >= 128): on chip at 4 chunks,
// streamed past that
template <int LIK>
int stats_wide_by_flags(const CellArgs& a, bool lg, bool st, const StatsOut& o,
                        cudaStream_t stream) {
  return tf32x3::padded_kc(a.K) / tf32x3::W_KC == W_NRES
             ? launch_stats_wide<W_NRES, LIK>(a, lg, st, o, stream)
             : launch_stats_wide<0, LIK>(a, lg, st, o, stream);
}

template <int LIK, bool LOG>
int launch_row_ll_wide(const CellArgs& a, float* out, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * row_ll_wide_smem_floats();
  const int err = prepare(row_ll_wide_kernel<LIK, LOG>, smem);
  if (err != 0) return err;
  const int blocks = a.S * ((a.B + TB - 1) / TB);
  row_ll_wide_kernel<LIK, LOG><<<blocks, THREADS, smem, stream>>>(a, out);
  return (int)cudaGetLastError();
}

template <int LIK>
int row_ll_wide_by_flags(const CellArgs& a, bool lg, float* out, cudaStream_t stream) {
  return lg ? launch_row_ll_wide<LIK, true>(a, out, stream)
            : launch_row_ll_wide<LIK, false>(a, out, stream);
}

}  // namespace

// As poisson_stats and poisson_row_ll of csrc/fused_poisson.cu, for the
// latent dimensions past their whole-K tiles; a K those take, or an unknown
// likelihood, is cudaErrorInvalidValue (1). dtheta is written whole.
extern "C" int poisson_stats_wide(const float* theta, const float* v,
                                  const float* phi, const float* x,
                                  const float* eta, const float* codes,
                                  const float* lgtab, double* psum, int* pcnt,
                                  float* pmin, float* dtheta, float* dv,
                                  float* dphi, int S, int B, int K, int D,
                                  int log_transform, int static_clip,
                                  int likelihood, float inv_scale,
                                  float norm_const, void* stream) {
  if (whole_k_fits(0, padded_k(K))) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && on16(v) && on16(phi) && on16(x) && on16(eta) && on16(codes) &&
                   on16(dv) && on16(dphi);
  const CellArgs a{theta, v, phi, x, eta, codes, lgtab, inv_scale, norm_const,
                   S, B, K, padded_k(K), D, vec, K % 4 == 0 && on16(theta)};
  const StatsOut o{psum, pcnt, pmin, dtheta, dv, dphi};
  const bool lg = log_transform != 0, st = static_clip != 0;
  cudaStream_t cs = (cudaStream_t)stream;
  switch (likelihood) {
    case LIK_POISSON: return stats_wide_by_flags<LIK_POISSON>(a, lg, st, o, cs);
    case LIK_BERNOULLI: return stats_wide_by_flags<LIK_BERNOULLI>(a, lg, st, o, cs);
    case LIK_NORMAL: return stats_wide_by_flags<LIK_NORMAL>(a, lg, st, o, cs);
    case LIK_POISSON_SOFTPLUS: return stats_wide_by_flags<LIK_POISSON_SOFTPLUS>(a, lg, st, o, cs);
    case LIK_MIXED: return stats_wide_by_flags<LIK_MIXED>(a, lg, st, o, cs);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int poisson_row_ll_wide(const float* theta, const float* v,
                                   const float* phi, const float* x,
                                   const float* eta, const float* codes,
                                   const float* lgtab, float* out, int S, int B,
                                   int K, int D, int log_transform, int likelihood,
                                   float inv_scale, float norm_const,
                                   void* stream) {
  if (whole_k_fits(1, padded_k(K))) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && on16(v) && on16(phi) && on16(x) && on16(eta) && on16(codes);
  const CellArgs a{theta, v, phi, x, eta, codes, lgtab, inv_scale, norm_const,
                   S, B, K, padded_k(K), D, vec, K % 4 == 0 && on16(theta)};
  const bool lg = log_transform != 0;
  cudaStream_t cs = (cudaStream_t)stream;
  switch (likelihood) {
    case LIK_POISSON: return row_ll_wide_by_flags<LIK_POISSON>(a, lg, out, cs);
    case LIK_BERNOULLI: return row_ll_wide_by_flags<LIK_BERNOULLI>(a, lg, out, cs);
    case LIK_NORMAL: return row_ll_wide_by_flags<LIK_NORMAL>(a, lg, out, cs);
    case LIK_POISSON_SOFTPLUS: return row_ll_wide_by_flags<LIK_POISSON_SOFTPLUS>(a, lg, out, cs);
    case LIK_MIXED: return row_ll_wide_by_flags<LIK_MIXED>(a, lg, out, cs);
  }
  return (int)cudaErrorInvalidValue;
}

// Registers a thread, static and dynamic shared memory a block and resident
// blocks an SM of the Poisson identity-link instance of the wide K1 (kind 0;
// its instance at padded K = 128) or K4 (kind 1), into info[0..3]; their
// shared memory does not depend on K.
extern "C" int poisson_wide_kernel_info(int kind, int* info) {
  return kind == 1
             ? kernel_info(row_ll_wide_kernel<LIK_POISSON, false>,
                           (int)sizeof(float) * row_ll_wide_smem_floats(), info)
             : kernel_info(stats_wide_kernel<W_NRES, LIK_POISSON>,
                           (int)sizeof(float) * stats_wide_smem_floats(), info);
}
