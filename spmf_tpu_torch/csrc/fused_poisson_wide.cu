// K1/K2 and K4 at every latent dimension past the whole-K tiles of
// csrc/fused_poisson.cu (K1/K2: padded K > 124, K4: > 152). They replace the
// same TPU kernels (spmf_tpu/ops/fused_poisson.py::_stats_grad_kernel,
// ::_sum_static_grad_kernel and ::_row_ll_kernel), which put the whole
// latent dimension in one block and set no limit on it. The tiling, the cells
// and the outputs are those of fused_poisson.cu: one block owns (row tile of
// TB = 128 rows, sample s) and loops over the column tiles of TD = 64; only
// the K-deep products are cut.
//
// The decode tv = theta . v needs the whole of K before any cell can be
// scored, so a block walks K in chunks of KC = 28 inside each column tile and
// never launches per chunk. A chunk is theta's TB rows at KC latent
// dimensions, row-major [TB][KC], and the v tile's KC rows [KC][TP]; the ring
// holds two, and cp.async brings the next while the block computes on the
// current one. Per column tile:
//   decode  chunks 0 .. n-1: acc (8 rows x 4 columns a thread, registers) +=
//           theta_c . v_c, k ascending as in the whole-K kernel; per 4 k one
//           float4 of theta for each of the thread's 8 rows and one of v for
//           each k: 12 loads for 128 multiply-adds;
//   cells   K1: the cells of fused_poisson.cuh's stats_cells (dtv in place in
//           the dtv tile); K4: row_ll_cells from the registers;
//   grads   (K1) chunks n-1 .. 0, the last decode chunk still in its stage:
//           dtheta[r][k] += sum_c dtv[r][c] v[k][c] and dv[k][c] +=
//           sum_r theta[r][k] dtv[r][c], the whole-K kernel's two products
//           cut to the chunk's latent dimensions.
// dtheta no longer fits shared memory (TB x K floats: 256 KB at K = 512), so
// it accumulates in device memory. A block owns its (sample, row tile) over
// every column tile (launch_geometry's block()), so each element has one
// owner thread: plain loads and stores, no atomics; the first column tile
// stores. That costs each tile a read and a write of the block's dtheta rows
// (2 x 4 TB K bytes: 128 KB at K = 128, from L2, where the S x B x K
// gradient, 16.8 MB at S = 8, B = 4096, K = 128, stays), and the theta chunks
// are read again in every column tile: 2n - 1 chunk loads a tile for K1, n
// for K4. The other way, looping the column tiles once per chunk, recomputes
// the decode n times. dv keeps its float4 atomics, one per (chunk, column
// tile) and element. K4 keeps its double per row owned by one thread: the
// same bits on every launch.
//
// Occupancy: K1/K2 take 112,768 bytes of dynamic shared memory (the ring
// 43,904, the x tile 32,768, the dtv tile 34,816, the lanes 768, dphi and
// the table 512) and K4 111,232 (the ring, two stages of the x tile and the
// lanes, the table), whatever K: two blocks an SM, and __launch_bounds__(256,
// 2) holds them to 128 registers (chip_smoke.py fails on a spill). KC = 28 is
// the widest chunk with which K1/K2 keep two blocks an SM.
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

// dtheta[r][kc0 + k] += sum_c dtv[r][c] v[k][c] for the chunk's kw latent
// dimensions. Work item m = rq (kw / 4) + kq takes rows rq + 32 i and
// latent dimensions kq + (kw / 4) j, as the whole-K kernel's add_dtheta_tile
// (neighbouring lanes read neighbouring v rows); dth_blk is the block's first
// row of dtheta, rows its rows that lie inside B. first: store, else add.
__device__ __forceinline__ void add_dtheta_chunk(const float* t_s, const float* vc, int kw,
                                                 float* __restrict__ dth_blk, int kc0, int rows,
                                                 int K, bool first) {
  const int nkq = kw / 4;
  const int items = (TB / 4) * nkq;
  for (int m = threadIdx.x; m < items; m += THREADS) {
    const int kq = m % nkq, rq = m / nkq;
    const float* a = t_s + rq * TP;
    const float* b = vc + kq * TP;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < TD; c += 4) {
      float4 d[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = ld4(a + i * (TB / 4) * TP + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ld4(b + j * nkq * TP + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(d[i].x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(d[i].y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(d[i].z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(d[i].w, w[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rq + (TB / 4) * i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = kc0 + kq + nkq * j;
        if (k < K) {
          float* o = dth_blk + (size_t)r * K + k;
          *o = first ? acc[i][j] : *o + acc[i][j];
        }
      }
    }
  }
}

// dv_s[kc0 + k][col0 + c] += sum_r theta[r][kc0 + k] dtv[r][c]: the whole-K
// kernel's add_dv_tile on the chunk, theta read row-major (per 4 rows a
// float4 of 4 latent dimensions from each row)
__device__ __forceinline__ void add_dv_chunk(const float* th, const float* t_s,
                                             float* __restrict__ dv_s, int kc0, int kw, int col0,
                                             int K, int D, bool vec) {
  const int lane = threadIdx.x & 31;
  const int cq = lane % TX, rh = lane / TX;
  for (int kq = threadIdx.x / 32; kq < kw / 4; kq += THREADS / 32) {
    const float* a = th + rh * (TB / 2) * KC + kq * 4;
    const float* b = t_s + rh * (TB / 2) * TP + cq * 4;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
#pragma unroll 2
    for (int r = 0; r < TB / 2; r += 4) {
      float4 tr[4], d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) tr[i] = ld4(a + (r + i) * KC);
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = ld4(b + (r + i) * TP);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float t = comp(tr[i], j);
          acc[j][0] = fmaf(t, d[i].x, acc[j][0]);
          acc[j][1] = fmaf(t, d[i].y, acc[j][1]);
          acc[j][2] = fmaf(t, d[i].z, acc[j][2]);
          acc[j][3] = fmaf(t, d[i].w, acc[j][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] += __shfl_xor_sync(FULL, acc[j][c], TX);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int k = kc0 + kq * 4 + rh * 2 + jj;
      const float o0 = rh ? acc[2 + jj][0] : acc[jj][0];
      const float o1 = rh ? acc[2 + jj][1] : acc[jj][1];
      const float o2 = rh ? acc[2 + jj][2] : acc[jj][2];
      const float o3 = rh ? acc[2 + jj][3] : acc[jj][3];
      if (k < K) atomic_add4(dv_s + (size_t)k * D, col0 + cq * 4, D, vec, o0, o1, o2, o3);
    }
  }
}

// ------------------------------------------------------------- K1 / K2
// The loads of a column tile, in ring order: q = 0 .. n-1 the decode's
// chunks, q = n .. 2n-2 the gradients' chunks n-2 .. 0 (chunk n-1 is the
// last decode chunk, still in its stage). After the tile's last load comes
// the next tile's first.
__device__ __forceinline__ int stats_chunk(int q, int n) { return q < n ? q : 2 * n - 2 - q; }

template <int LIK, bool LOG, bool STATIC>
__global__ void __launch_bounds__(THREADS, 2)
stats_wide_kernel(const CellArgs a, double* __restrict__ psum, int* __restrict__ pcnt,
                  float* __restrict__ pmin, float* __restrict__ dtheta, float* __restrict__ dv,
                  float* __restrict__ dphi) {
  extern __shared__ __align__(16) float smem[];
  const int K = a.K, KP = a.KP, B = a.B, D = a.D;
  float* ring = smem;                       // 2 x STAGE: theta [TB][KC], v [KC][TP]
  float* x_s = ring + 2 * STAGE;            // [TB][TD]  x tile
  float* t_s = x_s + TB * TD;               // [TB][TP]  tv, then d(sum)/d(theta.v)
  float* lane_s = t_s + TB * TP;            // [NLANE][TD] eta, phi, codes
  float* dphi_s = lane_s + NLANE * TD;      // [TD]
  float* tab_s = dphi_s + TD;               // [TABLE_N]

  const int s = blockIdx.x % a.S;           // samples of one row tile are adjacent
  const int r0 = (blockIdx.x / a.S) * TB;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const float* v_smp = a.v + (size_t)s * K * D;
  const float* phi_smp = a.phi + (size_t)s * D;
  float* dv_smp = dv + (size_t)s * K * D;
  float* dth_blk = dtheta + ((size_t)s * B + r0) * K;
  const int n = (KP + KC - 1) / KC;         // chunks
  const int last = 2 * n - 2;               // the last load of a tile

  load_x_tile(x_s, a.x, r0, 0, B, D, a.vec);
  load_lanes(lane_s, a, phi_smp, 0);
  load_chunk(ring, a, s, r0, v_smp, 0, 0);
  cp_async_commit();
  if (tid < TD) dphi_s[tid] = 0.0f;
  if (HAS_POISSON<LIK> && tid < TABLE_N) tab_s[tid] = a.lgtab[tid];

  double lsum = 0.0;
  int lcnt = 0;
  float lmin = 0.0f;
  int stage = 0;  // the stage of the chunk being computed on

  for (int col0 = 0; col0 < D; col0 += TD) {
    // request the load after load q of this tile into the other stage
    auto request_after = [&](int q) {
      const int nq = q < last ? q + 1 : 0, ncol = q < last ? col0 : col0 + TD;
      if (ncol < D) {
        load_chunk(ring + (stage ^ 1) * STAGE, a, s, r0, v_smp, stats_chunk(nq, n) * KC, ncol);
        cp_async_commit();
      }
    };
    float acc[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int q = 0; q < n; ++q) {
      cp_async_wait_all();
      __syncthreads();  // chunk q is in; the other stage's readers are done
      request_after(q);
      decode_chunk(ring + stage * STAGE, ring + stage * STAGE + TB * KC, min(KC, KP - q * KC), tx,
                   ty, acc);
      if (q < n - 1) stage ^= 1;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
      st4(t_s + tile_row(ty, i) * TP + tx * 4, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    stats_cells<LIK, LOG, STATIC>(a, t_s, x_s, lane_s, lane_s + TD, lane_s + 2 * TD, tab_s,
                                  dphi_s, r0, col0, lsum, lcnt, lmin);
    __syncthreads();  // dtv and dphi_s are whole; x_s and lane_s are free
    if (col0 + TD < D) {
      load_x_tile(x_s, a.x, r0, col0 + TD, B, D, a.vec);
      load_lanes(lane_s, a, phi_smp, col0 + TD);
      cp_async_commit();
    }
    if (tid < TX) {
      const float4 d = ld4(dphi_s + tid * 4);
      atomic_add4(dphi + (size_t)s * D, col0 + tid * 4, D, a.vec, d.x, d.y, d.z, d.w);
      st4(dphi_s + tid * 4, 0.0f, 0.0f, 0.0f, 0.0f);
    }

    const bool first = col0 == 0;
    for (int q = n - 1; q <= last; ++q) {
      if (q >= n) {
        cp_async_wait_all();
        __syncthreads();  // chunk stats_chunk(q) is in; the last chunk's readers are done
        stage ^= 1;
        request_after(q);
      }
      const int kc0 = stats_chunk(q, n) * KC, kw = min(KC, KP - kc0);
      const float* th = ring + stage * STAGE;
      add_dtheta_chunk(t_s, th + TB * KC, kw, dth_blk, kc0, B - r0, K, first);
      add_dv_chunk(th, t_s, dv_smp, kc0, kw, col0, K, D, a.vec);
    }
    stage ^= 1;  // the next tile's first chunk
  }
  write_block_stats<STATIC>(a.S, lsum, lcnt, lmin, psum, pcnt, pmin);
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
template <int LIK, bool LOG, bool STATIC>
int launch_stats_wide(const CellArgs& a, const StatsOut& o, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * stats_wide_smem_floats();
  const int err = prepare(stats_wide_kernel<LIK, LOG, STATIC>, smem);
  if (err != 0) return err;
  const int blocks = a.S * ((a.B + TB - 1) / TB);
  stats_wide_kernel<LIK, LOG, STATIC><<<blocks, THREADS, smem, stream>>>(
      a, o.psum, o.pcnt, o.pmin, o.dtheta, o.dv, o.dphi);
  return (int)cudaGetLastError();
}

template <int LIK>
int stats_wide_by_flags(const CellArgs& a, bool lg, bool st, const StatsOut& o,
                        cudaStream_t stream) {
  if (lg) {
    return st ? launch_stats_wide<LIK, true, true>(a, o, stream)
              : launch_stats_wide<LIK, true, false>(a, o, stream);
  }
  return st ? launch_stats_wide<LIK, false, true>(a, o, stream)
            : launch_stats_wide<LIK, false, false>(a, o, stream);
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
// blocks an SM of the Poisson identity-link instance of the wide K1 (kind 0)
// or K4 (kind 1), into info[0..3]; their shared memory does not depend on K.
extern "C" int poisson_wide_kernel_info(int kind, int* info) {
  return kind == 1
             ? kernel_info(row_ll_wide_kernel<LIK_POISSON, false>,
                           (int)sizeof(float) * row_ll_wide_smem_floats(), info)
             : kernel_info(stats_wide_kernel<LIK_POISSON, false, false>,
                           (int)sizeof(float) * stats_wide_smem_floats(), info);
}
