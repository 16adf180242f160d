// K1/K2 and K4 at every latent dimension past the whole-K kernels of
// csrc/fused_poisson.cu (K1/K2: padded K > 124, K4: > 64). They replace the
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
// K4 (row_ll_wide_kernel, ::_row_ll_kernel's per-row unclipped ll sums) runs
// the decode alone, 2 S B D K flops, on the same tensor cores: three TF32
// passes are 1.017 ms at S=8, B=4096, D=20000, K=128 (494.7 TFLOP/s), against
// 2.53 ms for one pass on the FP32 pipes, the route of the K-chunked kernel it
// replaces (chunks of 28 in a register micro-tile); the exps and logs of the
// log link (16 a clock and SM) read about 0.31 ms and do not bound it. Its
// design is split_tf32.cuh's decode (decode_step, load_v, split_v,
// load_theta): theta's A fragments split in registers (split_int), v split
// once a chunk into hi and lo, a fresh float32 partial a chunk (4 k-steps:
// tests/test_torch_row_ll_split.py reads 5.4e-7 against the row sums' 1e-5).
//
// The block has 16 warps: warp w the rows 16 (w % 8) .. +15 and the columns 32
// (w / 8) .. +31 of every 64-column tile (4 n8 tiles). The 8-warp layout of
// K1/K5's wide kernels (every warp over all 64 columns; RL_THREADS = 256,
// RL_NJ = 8) holds 208 registers, two warps a scheduler, and runs its cells
// and its decode in lock step with too few warps to hide their latencies:
// 7.02-7.20 ms at K=128 on an H100 80GB HBM3 at 700 W against this layout's
// 6.21-6.34 (115 registers, under the 128 that 512 threads allow), whose cells
// take about 1.3 ms and whose decode about 2.8
// (benchmarks/torch_row_ll_variants.py, its `no cells` and `no decode`
// builds). Scoring the last tile's cells between the next tile's k-steps
// instead, to overlap the two, ran out of registers and spilled, and a third
// raw v stage, loads two steps ahead, did not help.
//
// With no gradient products to hide loads under, the block walks steps Q =
// (column tile Q / n, chunk Q % n) of n chunks of 32, one barrier each: at the
// top of step Q the raw v chunk of step Q + 2 is requested into the stage step
// Q freed (cp.async, two stages) and step Q + 1's is split into the split
// buffer step Q - 1 read, so a chunk lands and is split under one step's
// products. Theta stays raw on chip to padded K = 256 ([TB][KPC + 4], loaded
// once a block); past that its chunks stream through two stages beside v's.
// The tile's x (pitch 72) and its eta / phi / codes lanes are requested at the
// tile's first step into one stage, the last tile's cells being done: they
// land under that step's products, as the chunks do, and a second stage would
// cost the room that keeps theta on chip to K = 256. The cells are scored from
// the C fragments (row_ll_cells_frag): a row's 8 cells of a thread in float32,
// the 4 lanes t by xor-shuffles, a double a row and half in its owner lane's
// registers; at the end the second half's doubles are added to the first's
// through shared memory, in that order: the same bits on every launch. Shared
// memory 224,256 bytes whatever K, no static, one block an SM,
// __launch_bounds__(512, 1); ptxas: 94 to 126 registers, no spill
// (chip_smoke.py fails on a spill).
#include "fused_poisson.cuh"

namespace {

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
// 16 warps: warp w the rows 16 (w % 8) .. +15 of the block and the columns
// 32 (w / 8) .. +31 of each tile (RL_NJ = 4 n8 tiles; RL_THREADS = 256 and
// RL_NJ = 8 are the 8-warp layout of K1/K5's wide kernels, which
// benchmarks/torch_row_ll_variants.py times); a partial a chunk
// (tests/test_torch_row_ll_split.py)
constexpr int RL_THREADS = 512;
constexpr int RL_NJ = 4;
constexpr int RL_PARTS = TD / (8 * RL_NJ);      // warps a row group, parts of a tile's columns
constexpr int RL_PART = tf32x3::W_KSC;
static_assert(RL_THREADS / 32 == RL_PARTS * (TB / 16) && (RL_PARTS == 1 || RL_PARTS == 2),
              "a warp a row group and part of the tile's columns");
static_assert(ROW_LL_WHOLE_K >= tf32x3::W_KC,
              "past the switch a tile has two chunks or more: its x, requested at "
              "its first step, has landed by the top of its second");
static_assert(2 * tf32x3::W_THS <= TB * (RL_KRES + 4), "streamed theta fits the resident room");
static_assert((RL_XP * 4) % 16 == 0, "x rows on 16 bytes");

template <int LIK, bool LOG>
__global__ void __launch_bounds__(RL_THREADS, 1)
row_ll_wide_kernel(const CellArgs a, float* __restrict__ out) {
  using tf32x3::W_KC;
  using tf32x3::W_THS;
  using tf32x3::W_VHL;
  using tf32x3::W_VP;
  using tf32x3::W_VRAW;
  constexpr int NT = RL_THREADS;
  extern __shared__ __align__(16) float smem[];
  float* th_s = smem;                           // [TB][KPC + 4], or 2 x [TB][KC + 4]
  float* vraw = th_s + TB * (RL_KRES + 4);      // 2 x [KC][TD] raw v chunks
  float* vhl = vraw + 2 * W_VRAW;               // 2 x split v chunks: hi [KC][VP], lo
  float* x_s = vhl + 2 * W_VHL;                 // [TB][RL_XP] the tile's x
  float* lane_s = x_s + TB * RL_XP;             // [NLANE][TD] eta, phi, codes
  float* tab_s = lane_s + NLANE * TD;           // [TABLE_N]

  const int K = a.K, B = a.B, D = a.D;
  const int s = blockIdx.x % a.S;               // samples of one row tile are adjacent
  const int r0 = (blockIdx.x / a.S) * TB;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int rw = (warp % (TB / 16)) * 16;       // this warp's first row in the block
  const int cb = (warp / (TB / 16)) * 8 * RL_NJ;  // ... and first column of a tile
  const float* th_blk = a.theta + ((size_t)s * B + r0) * K;
  const float* v_smp = a.v + (size_t)s * K * D;
  const float* phi_smp = a.phi + (size_t)s * D;
  const int kpc = tf32x3::padded_kc(K), n = kpc / W_KC;
  const bool res = kpc <= RL_KRES;              // theta on chip for the block's life
  const int thp = res ? kpc + 4 : W_KC + 4;     // 4 mod 32
  const int total = n * ((D + TD - 1) / TD);    // steps: chunk Q % n of tile Q / n
  const auto load_v_step = [&](int Q) {
    tf32x3::load_v<NT>(vraw + (Q & 1) * W_VRAW, v_smp, Q % n * W_KC, Q / n * TD, K, D, a.vec);
  };
  const auto load_th_step = [&](int Q) {
    tf32x3::load_theta<NT>(th_s + (Q & 1) * W_THS, W_KC + 4, th_blk, B - r0, K, Q % n * W_KC,
                           W_KC / 4, a.vec_theta);
  };
  const auto split_step = [&](int Q) {
    tf32x3::split_v<NT>(vraw + (Q & 1) * W_VRAW, vhl + (Q & 1) * W_VHL, W_KC * W_VP);
  };

  if (HAS_POISSON<LIK> && tid < TABLE_N) tab_s[tid] = a.lgtab[tid];
  if (res) tf32x3::load_theta<NT>(th_s, thp, th_blk, B - r0, K, 0, kpc / 4, a.vec_theta);
  else load_th_step(0);
  load_v_step(0);
  if (total > 1) load_v_step(1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  split_step(0);

  double sum0 = 0.0, sum8 = 0.0;                // rows rw + g and rw + g + 8, these columns
  float T[RL_NJ][4];
  for (int Q = 0; Q < total; ++Q) {
    const int c = Q % n, col0 = Q / n * TD;
    cp_async_wait_all();
    __syncthreads();  // step Q's v is split, Q + 1's raw is in; step Q - 1 is read
    if (!res && Q + 1 < total) load_th_step(Q + 1);
    if (Q + 2 < total) load_v_step(Q + 2);
    if (c == 0) {     // the last tile's cells are done
      load_x_tile<NT>(x_s, a.x, r0, col0, B, D, a.vec, RL_XP);
      load_lanes(lane_s, a, phi_smp, col0);
    }
    cp_async_commit();
    if (Q + 1 < total) split_step(Q + 1);
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < RL_NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) T[j][i] = 0.0f;
    }
    tf32x3::decode_step<RL_PART, RL_NJ>(res ? th_s + c * W_KC : th_s + (Q & 1) * W_THS, thp,
                                        vhl + (Q & 1) * W_VHL + cb, W_KC * W_VP,
                                        tf32x3::chunk_ksteps(K, c), rw, T);
    if (c == n - 1)   // x and the lanes landed by the top of the tile's second step
      row_ll_cells_frag<LIK, LOG>(a, T, x_s, RL_XP, lane_s, tab_s, r0, rw, cb, col0, sum0,
                                  sum8);
  }
  // a row's two halves, in a fixed order: the second half's doubles through
  // shared memory (the x tile's room), added to the first's
  if (RL_PARTS == 2) {
    double* half_s = reinterpret_cast<double*>(x_s);  // [TB]
    __syncthreads();  // every warp's cells are done
    if (cb > 0 && t == 0) {
      half_s[rw + g] = sum0;
      half_s[rw + g + 8] = sum8;
    }
    __syncthreads();
    if (cb == 0 && t == 0) {
      sum0 += half_s[rw + g];
      sum8 += half_s[rw + g + 8];
    }
  }
  if (cb == 0 && t == 0) {
    const size_t o = (size_t)s * B + r0 + rw + g;
    if (r0 + rw + g < B) out[o] = (float)sum0;
    if (r0 + rw + g + 8 < B) out[o + 8] = (float)sum8;
  }
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
  row_ll_wide_kernel<LIK, LOG><<<blocks, RL_THREADS, smem, stream>>>(a, out);
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
// its instance at padded K = 128) or K4 (kind 1; one instance for both of
// its routes), into info[0..3]; their shared memory does not depend on K.
extern "C" int poisson_wide_kernel_info(int kind, int* info) {
  return kind == 1
             ? kernel_info(row_ll_wide_kernel<LIK_POISSON, false>,
                           (int)sizeof(float) * row_ll_wide_smem_floats(), info, RL_THREADS)
             : kernel_info(stats_wide_kernel<W_NRES, LIK_POISSON>,
                           (int)sizeof(float) * stats_wide_smem_floats(), info);
}
