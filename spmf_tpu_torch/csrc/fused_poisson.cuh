// Shared by csrc/fused_poisson.cu (K1/K2 and K4 at the latent dimensions
// their whole-K kernels take) and csrc/fused_poisson_wide.cu (the
// K-chunked kernels past them): the tiling constants, the per-cell
// likelihoods, the asynchronous loads, the cell passes of one column tile and
// the reductions. See fused_poisson.cu for the design.
#pragma once
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "fast_math.cuh"  // div_normal
#include "split_tf32.cuh"  // the wide K1/K2's layout

namespace {

constexpr int THREADS = 256;
constexpr int TB = 128;            // rows per block
constexpr int TD = 64;             // columns per tile
constexpr int KS = 4;              // k-step: K is padded to a multiple of it
constexpr int TBP = TB + 4;        // row pitch of theta^T [KP][TBP]
constexpr int TP = TD + 4;         // row pitch of the v and dtv tiles: 4 mod 32,
                                   // so float4 reads of 8 rows miss each other
constexpr int NLANE = 3;           // eta, phi, codes: rows KP.. of the v tile
constexpr int TABLE_N = 64;        // entries of the lgamma(n + 1) table
constexpr int TX = TD / 4;         // column groups of the cell mapping (16)
constexpr int RI = 8;              // rows per thread in the cell mapping
constexpr float FLOOR = -1e27f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(TX * (TB / RI) == THREADS, "cell mapping covers the tile");
static_assert(TX == 16, "the row reductions assume 16 column lanes a row");

// ------------------------------------------------------ per-cell decode
// (out of line: behind the table it is the rare path of every cell)
__device__ __noinline__ float stirling_lgamma_xp1(float x) {
  // lgamma(x + 1) for x >= 0: 8-step shift and a Stirling series at z = x+9
  // (the TPU kernel's form; exact to f32 roundoff for x < ~4e9)
  const float z = x + 9.0f;
  const float zi = 1.0f / z;
  const float zi2 = zi * zi;
  const float series = (z - 0.5f) * logf(z) - z + 0.9189385332046727f +
                       zi * (1.0f / 12.0f + zi2 * (-1.0f / 360.0f + zi2 * (1.0f / 1260.0f)));
  const float p1 = (x + 1.0f) * (x + 2.0f) * (x + 3.0f) * (x + 4.0f);
  const float p2 = (x + 5.0f) * (x + 6.0f) * (x + 7.0f) * (x + 8.0f);
  return series - logf(p1) - logf(p2);
}

// lgamma(x + 1): the table for integer counts below TABLE_N, else (large
// counts, non-integers, the Normal columns of 'mixed', NaN) the series
__device__ __forceinline__ float lgamma_xp1(float x, const float* tab_s) {
  const int n = (int)x;
  if (x == (float)n && (unsigned)n < (unsigned)TABLE_N) return tab_s[n];
  return stirling_lgamma_xp1(x);
}

// log with its argument floored at FLT_MIN; NaN for negative and NaN rates
// (_safe_log: max(rate, tiny) keeps NaN, so no fmaxf here)
__device__ __forceinline__ float safe_log(float rate) {
  return rate < 0.0f ? __int_as_float(0x7fc00000) : logf(rate < FLT_MIN ? FLT_MIN : rate);
}

// rate = f(tv) * eta + phi; under LOG also ev = exp(tv * eta)
template <bool LOG>
__device__ __forceinline__ float decode_rate(float tv, float eta, float phi, float& ev) {
  if (LOG) {
    ev = expf(tv * eta);
    return ev - 1.0f + phi;
  }
  ev = 0.0f;
  return tv * eta + phi;
}

// x / lam gated by lam > FLT_MIN (a floored rate contributes nothing)
__device__ __forceinline__ float gated_ratio(float x, float lam) {
  return lam > FLT_MIN ? div_normal(x, fmaxf(lam, FLT_MIN)) : 0.0f;
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// 1 / (1 + exp(-x)) through t = exp(-|x|) in (0, 1], so the divisor stays in
// [1, 2]
__device__ __forceinline__ float sigmoidf(float x) {
  const float t = expf(-fabsf(x));
  return div_normal(x >= 0.0f ? 1.0f : t, 1.0f + t);
}

// The likelihood selector of spmf_tpu/ops/fused_poisson.py::_tile_ll and
// ::_tile_ll_grads; the values are the wrapper's (_LIKELIHOODS).
constexpr int LIK_POISSON = 0;
constexpr int LIK_BERNOULLI = 1;
constexpr int LIK_NORMAL = 2;
constexpr int LIK_POISSON_SOFTPLUS = 3;
constexpr int LIK_MIXED = 4;
constexpr float CODE_BERNOULLI = 1.0f;  // per-column codes of LIK_MIXED;
constexpr float CODE_NORMAL = 2.0f;     // anything else is a Poisson column

// the selectors with a Poisson branch: the ones that need lgamma(x + 1)
template <int LIK>
constexpr bool HAS_POISSON = LIK == LIK_POISSON || LIK == LIK_POISSON_SOFTPLUS || LIK == LIK_MIXED;

// ll of one cell and dll = d ll / d rate (dead code in K4, which drops it).
// inv_scale = 1 / obs_scale, norm_const = log(obs_scale) + log(2 pi) / 2,
// lgx = lgamma(x + 1) where the selector has a Poisson branch.
template <int LIK>
__device__ __forceinline__ float cell_ll(float x, float rate, float code, float inv_scale,
                                         float norm_const, float lgx, float& dll) {
  if (LIK == LIK_POISSON) {
    dll = gated_ratio(x, rate) - 1.0f;
    return x * safe_log(rate) - rate - lgx;
  }
  if (LIK == LIK_BERNOULLI) {  // rate plays the role of logits
    dll = x - sigmoidf(rate);
    return x * rate - softplusf(rate);
  }
  if (LIK == LIK_NORMAL) {
    const float r = (x - rate) * inv_scale;
    dll = r * inv_scale;
    return -0.5f * r * r - norm_const;
  }
  // Poisson on the softplus link, with a plain log: an underflowed lam gives
  // -inf or NaN, a clipped cell in K1/K2 and a NaN row in K4
  const float lam = softplusf(rate);
  const float sig = sigmoidf(rate);
  const float ll_p = x * logf(lam) - lam - lgx;
  const float dll_p = (gated_ratio(x, lam) - 1.0f) * sig;
  if (LIK == LIK_POISSON_SOFTPLUS) {
    dll = dll_p;
    return ll_p;
  }
  // mixed: always a select, never a multiply by a 0/1 mask (the branch not
  // taken may hold NaN: lgamma(x + 1) of a negative Normal observation)
  const float r = (x - rate) * inv_scale;
  const bool is_b = code == CODE_BERNOULLI, is_n = code == CODE_NORMAL;
  dll = is_b ? x - sig : (is_n ? r * inv_scale : dll_p);
  return is_b ? x * rate - lam : (is_n ? -0.5f * r * r - norm_const : ll_p);
}

// ------------------------------------------------------ asynchronous loads
// (csrc/split_tf32.cuh's, shared with K5 and the wide kernels' design)
using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait_all;
using tf32x3::load_group;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// x tile [TB][pitch] at rows r0.., columns col0.., zeros past row B and
// column D, by the block's NT threads: a thread keeps its column group and
// takes every (NT / 16)-th row
template <int NT = THREADS>
__device__ __forceinline__ void load_x_tile(float* x_s, const float* __restrict__ x, int r0,
                                            int col0, int B, int D, bool vec, int pitch = TD) {
  const int g = threadIdx.x % TX, rb = threadIdx.x / TX;
  const int col = col0 + g * 4;
  const float* src = x + (size_t)(r0 + rb) * D + col;
  float* dst = x_s + rb * pitch + g * 4;
  const size_t step = (size_t)(NT / TX) * D;
#pragma unroll
  for (int i = 0; i < TB / (NT / TX); ++i) {
    if (r0 + rb + i * (NT / TX) < B) load_group(dst, src, D - col, vec);
    else st4(dst, 0.0f, 0.0f, 0.0f, 0.0f);
    src += step;
    dst += (NT / TX) * pitch;
  }
}

// ------------------------------------------------------ the three products
// The cell mapping: thread (ty, tx) owns rows tile_row(ty, 0..7) and columns
// 4 tx .. 4 tx + 3 of the tile.
__device__ __forceinline__ int tile_row(int ty, int i) {
  return (i >> 2) * (TB / 2) + ty * 4 + (i & 3);
}

// four neighbouring floats of a global row added at once where the row is
// 16-byte aligned (vec), else one by one, past column D not at all
__device__ __forceinline__ void atomic_add4(float* __restrict__ row, int col, int D, bool vec,
                                            float a, float b, float c, float d) {
  if (vec) {
    if (col < D) atomicAdd(reinterpret_cast<float4*>(row + col), make_float4(a, b, c, d));
  } else {
    const float val[4] = {a, b, c, d};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < D) atomicAdd(row + col + i, val[i]);
  }
}

// ------------------------------------------------------------ reductions
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_down_sync(FULL, v, off));
  return v;
}

// block sum of a per-thread double, valid in thread 0
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double red[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = threadIdx.x < THREADS / 32 ? red[threadIdx.x] : 0.0;
  return threadIdx.x < 32 ? warp_sum(v) : 0.0;
}

// the arguments of K1/K2 and K4, as the C entry points receive them
struct CellArgs {
  const float *theta, *v, *phi, *x, *eta, *codes, *lgtab;
  float inv_scale, norm_const;
  int S, B, K, KP, D;
  bool vec;        // D % 4 == 0 and every base on 16 bytes
  bool vec_theta;  // K % 4 == 0 and theta on 16 bytes (the wide kernels'
                   // theta chunks load as 16-byte groups)
};

// ------------------------------------------------------ the cells of a tile
// K1/K2: this thread's cells of the tile (rows tile_row(ty, i), columns
// 4 tx ..). The decode product left tv in the thread's own cells of t_s and
// the loop below turns it into dtv in place, row by row: held in registers
// through an unrolled loop, the 32 accumulators made half of the instances
// spill under the 128-register cap, and a rolled loop is an eighth of the
// code. The clipped sum, count and minimum go into lsum / lcnt / lmin and
// the tile's d/d(phi) into dphi_s. eta_l, phi_l, code_l: the tile's lanes.
template <int LIK, bool LOG, bool STATIC>
__device__ __forceinline__ void stats_cells(const CellArgs& a, float* t_s, const float* x_s,
                                            const float* eta_l, const float* phi_l,
                                            const float* code_l, const float* tab_s,
                                            float* dphi_s, int r0, int col0, double& lsum,
                                            int& lcnt, float& lmin) {
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const float4 eta4 = ld4(eta_l + tx * 4);
  const float4 phi4 = ld4(phi_l + tx * 4);
  const float4 code4 = ld4(code_l + tx * 4);
  const float eta_c[4] = {eta4.x, eta4.y, eta4.z, eta4.w};
  const float phi_c[4] = {phi4.x, phi4.y, phi4.z, phi4.w};
  const float code_c[4] = {code4.x, code4.y, code4.z, code4.w};
  float drate_sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float tsum = 0.0f;  // this thread's 32 cells; the double sum takes it whole
#pragma unroll 2
  for (int i = 0; i < RI; ++i) {
    const int r = tile_row(ty, i);
    const bool row_ok = r0 + r < a.B;
    const float4 tv4 = ld4(t_s + r * TP + tx * 4);
    const float tv[4] = {tv4.x, tv4.y, tv4.z, tv4.w};
    const float4 x4 = ld4(x_s + r * TD + tx * 4);
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
    float dtv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool inb = row_ok && col0 + tx * 4 + j < a.D;
      float ev;
      const float rate = decode_rate<LOG>(tv[j], eta_c[j], phi_c[j], ev);
      const float lgx = HAS_POISSON<LIK> ? lgamma_xp1(xs[j], tab_s) : 0.0f;
      float dll;
      const float ll = cell_ll<LIK>(xs[j], rate, code_c[j], a.inv_scale, a.norm_const, lgx, dll);
      const bool finite = fabsf(ll) <= FLT_MAX;  // false for inf and NaN
      const bool keep = finite && ll > FLOOR;
      const bool active = inb && keep && ll < 0.0f;
      const float drate = active ? dll : 0.0f;
      // mask after the product: padded cells must contribute exact zeros
      dtv[j] = active ? drate * (LOG ? ev * eta_c[j] : eta_c[j]) : 0.0f;
      drate_sum[j] += drate;
      if (inb) {
        if (STATIC) {
          tsum += keep ? fminf(ll, 0.0f) : FLOOR;
        } else {
          if (finite) lmin = fminf(lmin, ll);
          if (keep) tsum += fminf(ll, 0.0f);
          else ++lcnt;
        }
      }
    }
    st4(t_s + r * TP + tx * 4, dtv[0], dtv[1], dtv[2], dtv[3]);
  }
  lsum += (double)tsum;
  // dphi of this tile: lanes l and l + 16 share their columns
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    drate_sum[j] += __shfl_xor_sync(FULL, drate_sum[j], TX);
    if ((tid & 31) < TX) atomicAdd(&dphi_s[tx * 4 + j], drate_sum[j]);
  }
}

// K4's unclipped ll of one cell from its decode sum tv: the rate at the
// link, lgamma(x + 1) where the selector needs it, the likelihood; one
// function for the whole-K kernel's micro-tile and the wide kernel's C
// fragments
template <int LIK, bool LOG>
__device__ __forceinline__ float row_cell_ll(const CellArgs& a, float tv, float x, float eta,
                                             float phi, float code, const float* tab_s) {
  float ev, dll;
  const float rate = decode_rate<LOG>(tv, eta, phi, ev);
  const float lgx = HAS_POISSON<LIK> ? lgamma_xp1(x, tab_s) : 0.0f;
  return cell_ll<LIK>(x, rate, code, a.inv_scale, a.norm_const, lgx, dll);
}

// K4: the cells of this thread from the decode sums in its registers; a
// row's 64 cells of the tile summed in float32 (4 in a thread, 16 lanes by
// shuffle) and added into the row's double in row_sum by one owner thread.
template <int LIK, bool LOG>
__device__ __forceinline__ void row_ll_cells(const CellArgs& a, const float (&acc)[RI][4],
                                             const float* xt, const float* eta_l,
                                             const float* phi_l, const float* code_l,
                                             const float* tab_s, double* row_sum, int r0,
                                             int col0) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const float4 eta4 = ld4(eta_l + tx * 4);
  const float4 phi4 = ld4(phi_l + tx * 4);
  const float4 code4 = ld4(code_l + tx * 4);
  const float eta_c[4] = {eta4.x, eta4.y, eta4.z, eta4.w};
  const float phi_c[4] = {phi4.x, phi4.y, phi4.z, phi4.w};
  const float code_c[4] = {code4.x, code4.y, code4.z, code4.w};
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = tile_row(ty, i);
    const bool row_ok = r0 + r < a.B;
    const float4 x4 = ld4(xt + r * TD + tx * 4);
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
    // this row's cells of the tile: 4 here, then the 16 lanes of the row
    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool inb = row_ok && col0 + tx * 4 + j < a.D;
      const float ll = row_cell_ll<LIK, LOG>(a, acc[i][j], xs[j], eta_c[j], phi_c[j], code_c[j],
                                             tab_s);
      part += inb ? ll : 0.0f;  // select: a NaN ll stays NaN
    }
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
    if (tx == 0) row_sum[r] += (double)part;
  }
}

// K4 past its switch (csrc/fused_poisson_wide.cu): the cells of a warp's
// 16 rows (rw ..) and 8 NJ columns (cb ..) of a tile from the decode's C
// fragments: thread (g, t) holds rows rw + g (T[j][0], T[j][1]) and rw + g
// + 8 (T[j][2], T[j][3]) at columns cb + 8j + 2t and cb + 8j + 2t + 1. x in
// x_s [TB][xp] and the lanes [NLANE][TD] are read at those positions as
// float2 (xp 8 mod 32: a half-warp's 16 float2 loads hit 32 distinct
// banks). A row's 2 NJ cells of this thread are summed in float32 (j, then
// the column pair), the 4 lanes t by xor-shuffles (t ^ 1, then t ^ 2:
// every lane holds the same bits), and added into the rows' doubles, sum0
// (row rw + g) and sum8 (rw + g + 8).
template <int LIK, bool LOG, int NJ>
__device__ __forceinline__ void row_ll_cells_frag(const CellArgs& a, const float (&T)[NJ][4],
                                                  const float* x_s, int xp, const float* lane_s,
                                                  const float* tab_s, int r0, int rw, int cb,
                                                  int col0, double& sum0, double& sum8) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float part[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = cb + 8 * j + 2 * t;
    const float2 eta2 = ld2(lane_s + c);
    const float2 phi2 = ld2(lane_s + TD + c);
    const float2 code2 = ld2(lane_s + 2 * TD + c);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rw + g + 8 * rr;
      const bool row_ok = r0 + r < a.B;
      const float2 x2 = ld2(x_s + r * xp + c);
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const bool inb = row_ok && col0 + c + cc < a.D;
        const float ll = row_cell_ll<LIK, LOG>(a, T[j][2 * rr + cc], cc ? x2.y : x2.x,
                                               cc ? eta2.y : eta2.x, cc ? phi2.y : phi2.x,
                                               cc ? code2.y : code2.x, tab_s);
        part[rr] += inb ? ll : 0.0f;  // select: a NaN ll stays NaN
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    part[rr] += __shfl_xor_sync(FULL, part[rr], 1);
    part[rr] += __shfl_xor_sync(FULL, part[rr], 2);
  }
  sum0 += (double)part[0];
  sum8 += (double)part[1];
}

// K1/K2's per-block partials of the per-sample statistics, at the block's
// end: psum, pcnt and pmin at [sample][row tile]
template <bool STATIC>
__device__ __forceinline__ void write_block_stats(int S, double lsum, int lcnt, float lmin,
                                                  double* __restrict__ psum, int* __restrict__ pcnt,
                                                  float* __restrict__ pmin) {
  __shared__ int red_cnt[THREADS / 32];
  __shared__ float red_min[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  lcnt = warp_sum(lcnt);
  lmin = warp_min(lmin);
  if (lane == 0) {
    red_cnt[warp] = lcnt;
    red_min[warp] = lmin;
  }
  lsum = block_sum(lsum);  // synchronises the block after the stores above
  if (warp == 0) {
    lcnt = lane < THREADS / 32 ? red_cnt[lane] : 0;
    lmin = lane < THREADS / 32 ? red_min[lane] : 0.0f;
    lcnt = warp_sum(lcnt);
    lmin = warp_min(lmin);
    if (lane == 0) {
      const int out = (blockIdx.x % S) * (gridDim.x / S) + blockIdx.x / S;
      psum[out] = lsum;
      if (!STATIC) {
        pcnt[out] = lcnt;
        pmin[out] = lmin;
      }
    }
  }
}

// ------------------------------------------------------------- K1 / K2
// floats of dynamic shared memory; the wrapper's launch_geometry computes
// the same number and poisson_smem_bytes exports this one
constexpr int stats_smem_floats(int KP) {
  return KP * TBP + TB * KP + (KP + NLANE) * TP + TB * TD + TB * TP + TD + TABLE_N;
}

// ------------------------------------------------------------------ K4
constexpr int row_ll_smem_floats(int KP) {
  return KP * TBP + 2 * (KP + NLANE) * TP + 2 * TB * TD + TABLE_N;
}

// ------------------------------------------------------- the wide kernels
// (csrc/fused_poisson_wide.cu). K1/K2 take csrc/split_tf32.cuh's shared
// memory, the eta / phi / codes lanes, a row of dphi a warp and the table;
// K4 theta on chip to padded K = RL_KRES ([TB][KPC + 4], else two streamed
// chunks [TB][KC + 4]), two raw and two split v chunks, one x tile at pitch
// RL_XP, its lanes and the table. One block an SM, whatever K.
constexpr int RL_KRES = 256;        // K4: theta stays on chip to this padded K
constexpr int RL_XP = TD + 8;       // K4: pitch of the x tile, 8 mod 32
constexpr int stats_wide_smem_floats() {
  return tf32x3::W_RES + NLANE * TD + (THREADS / 32) * TD + TABLE_N;
}
constexpr int row_ll_wide_smem_floats() {
  return TB * (RL_KRES + 4) + 2 * tf32x3::W_VRAW + 2 * tf32x3::W_VHL + TB * RL_XP + NLANE * TD +
         TABLE_N;
}

// K4's switch: the whole-K kernel (FP32 pipes) to padded K = 64, the wide
// kernel (split-TF32 tensor cores) past it
constexpr int ROW_LL_WHOLE_K = 64;

// Hopper's shared memory a block may take, and K1/K2's static shared memory
// (the stats reductions' 128 bytes)
constexpr int SMEM_LIMIT = 232448;
constexpr int STATS_STATIC = 128;

// K1/K2 (kind 0) takes the whole-K kernel while its tiles fit a block at
// padded latent dimension KP (KP <= 124), K4 (kind 1) to its switch (KP <=
// 64); the wide kernel past that
inline bool whole_k_fits(int kind, int KP) {
  return kind == 1 ? KP <= ROW_LL_WHOLE_K
                   : (int)sizeof(float) * stats_smem_floats(KP) + STATS_STATIC <= SMEM_LIMIT;
}

// bytes of dynamic shared memory of the kernel that K1/K2 (kind 0) or K4
// (kind 1) launches at latent dimension K (the wrapper's launch_geometry
// computes the same)
inline int smem_bytes(int kind, int K) {
  const int KP = (K + KS - 1) / KS * KS;
  if (whole_k_fits(kind, KP))
    return (int)sizeof(float) * (kind == 1 ? row_ll_smem_floats(KP) : stats_smem_floats(KP));
  return (int)sizeof(float) * (kind == 1 ? row_ll_wide_smem_floats() : stats_wide_smem_floats());
}

inline bool on16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// registers, static and dynamic shared memory and resident blocks per SM of
// a kernel at `smem` dynamic bytes and `threads` a block, into info[0..3]
template <typename Kernel>
int kernel_info(Kernel kernel, int smem, int* info, int threads = THREADS) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err != 0) return err;
  err = prepare(kernel, smem);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  return err;
}

struct StatsOut {
  double* psum;
  int* pcnt;
  float* pmin;
  float *dtheta, *dv, *dphi;
};

inline int padded_k(int K) { return (K + KS - 1) / KS * KS; }

}  // namespace
