// K5 for Hopper: the exp-rate total of the sparse energy under the log link,
// with its gradients at unit cotangent. Replaces spmf_tpu/ops/
// fused_poisson.py::_expsum_grad_kernel (fused_exp_rate_sum). Per ELBO
// sample s, over every cell (b, d) of the batch:
//   T    = theta_s @ v_s                      (B, D), K-deep
//   R_s  = sum_bd exp(T[b, d] eta[d])
//   G    = exp(T eta) eta                      dR / dT
//   dtheta_s = G @ v_s^T  (B, K),  dv_s = theta_s^T @ G  (K, D)
//
// What bounds it on an H100: the three K-deep products, 6 S B D K flops (126
// GFLOP at S=8, B=4096, D=20000, K=32), against 655 M exps and about 10 MB of
// operands. On the FP32 pipes (67 TFLOP/s) the products alone take 1.9 ms;
// on the tensor cores in TF32 (495 TFLOP/s dense) 0.25 ms a pass. TF32 keeps
// 10 mantissa bits, too few for the tolerances the kernel is held to (sums
// 1e-5 relative, gradients 1e-4 of their largest entry, against float64), so
// every product runs as three TF32 passes on split operands:
//   hi = cvt.rna.tf32.f32(x),  lo = cvt.rna.tf32.f32(x - hi),
//   a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b    (lo lo dropped, ~2^-22 a b)
// added to a float32 accumulator in that order, the small terms first
// (tests/test_torch_expsum_split.py emulates this arithmetic on the CPU). The
// bound is then 3 x 126 GFLOP at 495 TFLOP/s, 0.76 ms.
//
// The products are mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in
// inline PTX. Fragments of one m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row)   a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B (8 x 8, col)    b0 (t, g)   b1 (t+4, g)
//   C (16 x 8)        c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// One block owns (sample s, 128 rows); samples of one row tile are adjacent
// in the grid. 8 warps, warp w the rows 16w .. 16w+15; the block loops over D
// in column tiles of 64. K is padded with zeros to KP, a multiple of 8 (a
// template parameter KS = KP / 8 to K = 64; past that the K-chunked
// expsum_wide_kernel below, on the same tiling).
//  - For the block's life each warp holds in registers the A fragments of its
//    16 x KP slice of theta, hi and lo (to KP = 32; wider instances re-read
//    them from shared memory), and its dtheta sums (16 x KP): the
//    rows belong to this block alone, so dtheta leaves once, by plain
//    stores, with no atomics.
//  - Every mma accumulates from zero over at most 16 k-steps: the tensor
//    cores add into their float32 accumulator without rounding to nearest,
//    a bias that grows with the number of additions. dtheta's products run
//    into a fresh partial per half tile, added to the sums in float32.
//  - decode   T_w (16 x 64) = theta_w @ v: 8 n8 tiles x KS k-steps x 3 mma,
//    in two halves of 32 columns (decode, cells, dtheta) to save registers.
//  - cells    in the accumulators: E = __expf(T eta), ex2.approx of T eta
//    log2(e), within 2 + 1.16 |T eta| ulp (faster than expf, and inside the
//    same tolerances); out-of-range rows and columns become exact zeros by
//    a select after the exp; tsum += E in float32 per tile, then into a
//    double per thread; G = E eta in place.
//  - dtheta   dtheta_w (16 x KP) += G_w (16 x 64) @ v^T (64 x KP), with no
//    trip through shared memory: the C fragment of G's n8 tile j serves as
//    the A fragment of the k-step over columns 8j .. 8j+7 under the column
//    permutation k = t <-> column 2t, k = t+4 <-> column 2t+1, i.e.
//    a0 = c0, a1 = c2, a2 = c1, a3 = c3; the B fragment takes the same
//    permutation, b0 = v[n = g][8j + 2t], b1 = v[g][8j + 2t + 1], one float2
//    load. (A k-permutation applied to both operands leaves the product as
//    it is; without it G would need shuffles or shared memory.)
//  - dv       dv (KP x 64) += theta^T (KP x 128) @ G (128 x 64) through a G
//    tile in shared memory: warp w takes the n8 tile of columns 8w .. 8w+7
//    and every m16 tile of the latent dimension (KP rounded up to 16 there),
//    over the block's 128 rows in 16 k-steps, theta^T's A fragments by
//    ldmatrix (rows on 16 bytes: pitch 132); each finished tile leaves by
//    float2 atomics on columns (2t, 2t+1) (red.global.add.v2.f32), one per
//    element and block.
// Shared memory (floats; pitches chosen so that the lanes (g, t) of every
// 4-byte fragment load hit 32 distinct banks, and a half-warp's float2 loads
// 16 distinct bank pairs):
//   raw     [KP + 1][64]   the v tile and its eta lane as cp.async lands
//                          them (16-byte path; 4-byte for D % 4 != 0 or an
//                          unaligned base); rows K .. KP-1 zero
//   v hi/lo [KP][72] x 2   the tile split once per tile for all 8 warps
//                          (pitch 8 mod 32), and the tile's 64 eta values
//   th hi/lo [KP16][132] x 2  theta^T of the block, split once (4 mod 32)
//   G       [128][72]      the block's G of the tile (8 mod 32)
// 97,792 bytes at K = 32, so two blocks fit an SM (__launch_bounds__(256, 2)
// for KP <= 32; one block above). Tile j+1 is requested into raw as soon as
// tile j is split, and lands under tile j's three products: raw and the split
// tile are the two stages.
// The rate total: each thread's double, reduced by warp shuffles into eight
// shared doubles, summed by one thread in a fixed order into psum[s][row
// tile]: two launches give the same bits. dv's float atomics run in no fixed
// order (float32 sums compared with tolerances). An exp that overflows
// makes lo = inf - inf, NaN, where the float64 twin keeps inf.
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TB = 128;         // rows per block, 16 per warp
constexpr int TD = 64;          // columns per tile
constexpr int RP = TD;          // row pitch of the raw tile (16-byte rows)
constexpr int VP = TD + 8;      // row pitch of v hi/lo and G: 8 mod 32
constexpr int TBP = TB + 4;     // row pitch of theta^T hi/lo: 4 mod 32
constexpr int KS_MAX = 8;       // K <= 64
constexpr unsigned FULL = 0xffffffffu;

static_assert(WARPS * 16 == TB, "a warp owns 16 rows of the block");
static_assert(WARPS * 8 == TD, "a warp owns an n8 tile of dv");

__host__ __device__ constexpr int kp16(int KP) { return (KP + 15) / 16 * 16; }

// floats of dynamic shared memory at padded latent dimension KP; the
// wrapper's launch_geometry('expsum') computes the same number
__host__ __device__ constexpr int smem_floats(int KP) {
  return (KP + 1) * RP + 2 * KP * VP + TD + 2 * kp16(KP) * TBP + TB * VP;
}

// ------------------------------------------------------ the split products
// (csrc/split_tf32.cuh, shared with the wide K1/K2)
using tf32x3::bits;
using tf32x3::mma3;
using tf32x3::split;

// ------------------------------------------------------ asynchronous loads
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait_all;
using tf32x3::load_group;

// raw rows k < K: v_smp (K, D) at columns col0 .. col0+63; row KP: eta
__device__ __forceinline__ void load_raw(float* raw, const float* __restrict__ v_smp,
                                         const float* __restrict__ eta, int col0, int K, int KP,
                                         int D, bool vec) {
  const int gi = threadIdx.x % (TD / 4);
  const int col = col0 + gi * 4;
  for (int k = threadIdx.x / (TD / 4); k <= K; k += THREADS / (TD / 4)) {
    const float* src = (k < K ? v_smp + (size_t)k * D : eta) + col;
    load_group(raw + (k < K ? k : KP) * RP + gi * 4, src, D - col, vec);
  }
}

// dv_smp[k][c], [c + 1] += (a, b) where k < K and the columns < D; pair: D
// even and dv 8-byte aligned, so c (even) and c + 1 are in or out together
__device__ __forceinline__ void add_pair(float* __restrict__ dv_smp, int k, int c, int K, int D,
                                         bool pair, float a, float b) {
  if (k >= K) return;
  float* p = dv_smp + (size_t)k * D + c;
  if (pair) {
    if (c < D) atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
  } else {
    if (c < D) atomicAdd(p, a);
    if (c + 1 < D) atomicAdd(p + 1, b);
  }
}

// the A fragments (hi, lo) of theta's rows rw .. rw+15 at k-step ks, from
// theta^T [k][row] in shared memory
__device__ __forceinline__ void load_a(const float* th_hi, const float* th_lo, int ks, int rw,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int o = (8 * ks + t) * TBP + rw + g;
  const int off[4] = {o, o + 8, o + 4 * TBP, o + 4 * TBP + 8};  // a0 (g, t) .. a3 (g+8, t+4)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = bits(th_hi[off[i]]);
    lo[i] = bits(th_lo[off[i]]);
  }
}

// The A fragment of one m16n8k8 from a row-major [m][k] tile in shared
// memory, all four registers in one ldmatrix: lane L passes the address of
// row L % 8 of 8 x 4-word matrix L / 8, the matrices being a0 .. a3 (rows
// 0-7 / 8-15, words 0-3 / 4-7), and receives word L % 4 of row L / 4 of
// each. Rows must start on 16 bytes.
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const float* lane_row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(lane_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// ------------------------------------------------------------------ kernel
template <int KS>
__global__ void __launch_bounds__(THREADS, KS <= 4 ? 2 : 1)
expsum_kernel(const float* __restrict__ theta, const float* __restrict__ v,
              const float* __restrict__ eta, double* __restrict__ psum,
              float* __restrict__ dtheta, float* __restrict__ dv, int S, int B, int K, int D,
              bool vec, bool pair) {
  constexpr int KP = 8 * KS;
  constexpr int M16 = kp16(KP) / 16;        // m16 tiles of dv
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                        // [KP + 1][RP]
  float* v_hi = raw + (KP + 1) * RP;        // [KP][VP]
  float* v_lo = v_hi + KP * VP;             // [KP][VP]
  float* eta_s = v_lo + KP * VP;            // [TD]
  float* th_hi = eta_s + TD;                // [16 M16][TBP] theta^T
  float* th_lo = th_hi + 16 * M16 * TBP;    // [16 M16][TBP]
  float* g_s = th_lo + 16 * M16 * TBP;      // [TB][VP]
  __shared__ double red[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s = blockIdx.x % S;             // samples of one row tile are adjacent
  const int r0 = (blockIdx.x / S) * TB;
  const int rw = warp * 16;                 // this warp's first row in the block
  const float* v_smp = v + (size_t)s * K * D;
  float* dv_smp = dv + (size_t)s * K * D;

  for (int p = tid; p < (KP - K) * RP; p += THREADS) raw[K * RP + p] = 0.0f;
  load_raw(raw, v_smp, eta, 0, K, KP, D, vec);
  cp_async_commit();
  // theta^T of the block, split; zeros past row B and past latent dim K
  for (int p = tid; p < TB * 16 * M16; p += THREADS) {
    const int r = p / (16 * M16), k = p % (16 * M16);
    const float x = (r0 + r < B && k < K) ? theta[((size_t)s * B + r0 + r) * K + k] : 0.0f;
    uint32_t hi, lo;
    split(x, hi, lo);
    th_hi[k * TBP + r] = __uint_as_float(hi);
    th_lo[k * TBP + r] = __uint_as_float(lo);
  }
  __syncthreads();

  // this warp's A fragments of theta (rows rw .. rw+15), for the block's
  // life where they fit the registers (KP <= 32); past that the decode
  // reads them from theta^T in shared memory at each k-step
  constexpr bool A_REGS = KS <= 4;
  uint32_t a_hi[A_REGS ? KS : 1][4], a_lo[A_REGS ? KS : 1][4];
  if constexpr (A_REGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) load_a(th_hi, th_lo, ks, rw, a_hi[ks], a_lo[ks]);
  }
  float dth[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dth[n][i] = 0.0f;
  const bool row_ok = r0 + rw + g < B, row8_ok = r0 + rw + g + 8 < B;
  double rsum = 0.0;

  for (int col0 = 0; col0 < D; col0 += TD) {
    cp_async_wait_all();
    __syncthreads();  // raw holds this tile; the last tile's products are done
    for (int p = tid; p < KP * (TD / 4); p += THREADS) {
      const int k = p / (TD / 4), c = (p % (TD / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(raw + k * RP + c);
      uint32_t h[4], l[4];
      split(x.x, h[0], l[0]);
      split(x.y, h[1], l[1]);
      split(x.z, h[2], l[2]);
      split(x.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(v_hi + k * VP + c) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(v_lo + k * VP + c) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    if (tid < TD) eta_s[tid] = raw[KP * RP + tid];
    __syncthreads();  // the split tile is whole; raw is free
    if (col0 + TD < D) {
      load_raw(raw, v_smp, eta, col0 + TD, K, KP, D, vec);
      cp_async_commit();
    }

    // Two halves of 32 columns, so that decode, cells, dtheta and G's
    // stores hold 16 accumulators a thread, not 32
    float tsum = 0.0f;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      // decode: acc[j] is the C fragment of T's n8 tile 4h + j
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // b0 = v[8 ks + t][32 h + 8 j + g], b1 four rows on
        const int o = (8 * ks + t) * VP + 32 * h + g;
        uint32_t ah[4], al[4];
        if constexpr (A_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = a_hi[ks][i];
            al[i] = a_lo[ks][i];
          }
        } else {
          load_a(th_hi, th_lo, ks, rw, ah, al);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma3(acc[j], ah, al, bits(v_hi[o + 8 * j]), bits(v_hi[o + 4 * VP + 8 * j]),
               bits(v_lo[o + 8 * j]), bits(v_lo[o + 4 * VP + 8 * j]));
      }

      // cells: E, its masked sum, and G = E eta in place of T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * h + 8 * j + 2 * t;
        const float2 e = *reinterpret_cast<const float2*>(eta_s + c);
        const bool c_ok = col0 + c < D, c1_ok = col0 + c + 1 < D;
        const float x0 = __expf(acc[j][0] * e.x), x1 = __expf(acc[j][1] * e.y);
        const float x2 = __expf(acc[j][2] * e.x), x3 = __expf(acc[j][3] * e.y);
        const float m0 = row_ok && c_ok ? x0 : 0.0f, m1 = row_ok && c1_ok ? x1 : 0.0f;
        const float m2 = row8_ok && c_ok ? x2 : 0.0f, m3 = row8_ok && c1_ok ? x3 : 0.0f;
        tsum += (m0 + m1) + (m2 + m3);
        acc[j][0] = m0 * e.x;
        acc[j][1] = m1 * e.y;
        acc[j][2] = m2 * e.x;
        acc[j][3] = m3 * e.y;
      }

      // dtheta_w += G_w @ v^T over these 32 columns: G's C fragments as A
      // fragments (see the top). The tensor cores add into their float32
      // accumulator without rounding to nearest (a sum over all of D in one
      // accumulator read 2e-4 low at D = 20,000), so each half starts a
      // fresh partial, which a plain float32 add takes into dth.
      float part[KS][4];
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[n][i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t a_h[4], a_l[4];
        split(acc[j][0], a_h[0], a_l[0]);  // a0 (g, k = t)     = c0 (g, 2t)
        split(acc[j][2], a_h[1], a_l[1]);  // a1 (g+8, k = t)   = c2 (g+8, 2t)
        split(acc[j][1], a_h[2], a_l[2]);  // a2 (g, k = t+4)   = c1 (g, 2t+1)
        split(acc[j][3], a_h[3], a_l[3]);  // a3 (g+8, k = t+4) = c3 (g+8, 2t+1)
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          const int o = (8 * n + g) * VP + 32 * h + 8 * j + 2 * t;
          const float2 hv = *reinterpret_cast<const float2*>(v_hi + o);
          const float2 lv = *reinterpret_cast<const float2*>(v_lo + o);
          mma3(part[n], a_h, a_l, bits(hv.x), bits(hv.y), bits(lv.x), bits(lv.y));
        }
      }
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dth[n][i] += part[n][i];

      // G to shared memory for dv (the last tile's readers are done: the
      // barriers above)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = (rw + g) * VP + 32 * h + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(g_s + o) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(g_s + o + 8 * VP) = make_float2(acc[j][2], acc[j][3]);
      }
    }
    rsum += (double)tsum;
    __syncthreads();

    // dv (columns 8 warp ..) += theta^T @ G over the block's rows
    float dacc[M16][4];
#pragma unroll
    for (int m = 0; m < M16; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) dacc[m][i] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < TB / 8; ++kk) {
      const int ob = (8 * kk + t) * VP + 8 * warp + g;  // b0 = G[8 kk + t][8 warp + g]
      uint32_t bh0, bl0, bh1, bl1;
      split(g_s[ob], bh0, bl0);
      split(g_s[ob + 4 * VP], bh1, bl1);
#pragma unroll
      for (int m = 0; m < M16; ++m) {
        // a0 = theta^T[16m + g][8 kk + t]; this lane's row of the four matrices
        const int o = (16 * m + (lane & 7) + 8 * ((lane >> 3) & 1)) * TBP + 8 * kk +
                      4 * (lane >> 4);
        uint32_t a_h[4], a_l[4];
        ldsm_a(a_h, th_hi + o);
        ldsm_a(a_l, th_lo + o);
        mma3(dacc[m], a_h, a_l, bh0, bh1, bl0, bl1);
      }
    }
    const int c = col0 + 8 * warp + 2 * t;
#pragma unroll
    for (int m = 0; m < M16; ++m) {
      add_pair(dv_smp, 16 * m + g, c, K, D, pair, dacc[m][0], dacc[m][1]);
      add_pair(dv_smp, 16 * m + g + 8, c, K, D, pair, dacc[m][2], dacc[m][3]);
    }
  }

  // dtheta: C fragments of the n8 tiles of the latent dimension, rows of
  // this block alone, one plain store each
  float* out = dtheta + ((size_t)s * B + r0 + rw + g) * K;
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    const int k = 8 * n + 2 * t;
    if (row_ok) {
      if (k < K) out[k] = dth[n][0];
      if (k + 1 < K) out[k + 1] = dth[n][1];
    }
    if (row8_ok) {
      if (k < K) out[8 * K + k] = dth[n][2];
      if (k + 1 < K) out[8 * K + k + 1] = dth[n][3];
    }
  }

  // the rate total of the block, in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rsum += __shfl_down_sync(FULL, rsum, off);
  if (lane == 0) red[warp] = rsum;
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += red[w];
    psum[s * (gridDim.x / S) + blockIdx.x / S] = total;
  }
}

// ------------------------------------------------------------ the wide path
// Past K = 64 neither theta's A fragments nor the dtheta sums fit the
// registers. The wide kernel is csrc/split_tf32.cuh's K-chunked design
// (shared with the wide K1/K2): to padded K = 128 (N = 3 or 4 chunks) theta,
// the tile's split v and dtheta (in registers, written once) stay on chip;
// past that (N = 0) the chunks stream and dtheta accumulates in device
// memory by its owner thread. A fragments split in registers, v once per
// load, G once per tile, dv by float4 atomics. Its cells: E = __expf(T
// eta) (as above), its masked sum into a double per thread, G = E eta. The
// arithmetic is the kernel's above cut into chunks: a fresh decode partial
// per chunk (4 k-steps), dtheta's per 32 columns (the tile's two added in
// float32), dv's 16 k-steps a block; the rate
// total's order is fixed, so two launches give the same R and dtheta.
using tf32x3::W_KC;
using tf32x3::W_RES;
using tf32x3::padded_kc;

__host__ __device__ constexpr int wide_smem_floats() { return W_RES + TD; }

// cells of the warp's tile: E, its masked sum (returned), G = E eta in
// place of T
__device__ __forceinline__ float exp_cells(float (&T)[8][4], const float* eta_s, int col0, int D,
                                           bool row_ok, bool row8_ok) {
  const int t = threadIdx.x & 3;
  float tsum = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 e = *reinterpret_cast<const float2*>(eta_s + c);
    const bool c_ok = col0 + c < D, c1_ok = col0 + c + 1 < D;
    const float x0 = __expf(T[j][0] * e.x), x1 = __expf(T[j][1] * e.y);
    const float x2 = __expf(T[j][2] * e.x), x3 = __expf(T[j][3] * e.y);
    const float m0 = row_ok && c_ok ? x0 : 0.0f, m1 = row_ok && c1_ok ? x1 : 0.0f;
    const float m2 = row8_ok && c_ok ? x2 : 0.0f, m3 = row8_ok && c1_ok ? x3 : 0.0f;
    tsum += (m0 + m1) + (m2 + m3);
    T[j][0] = m0 * e.x;
    T[j][1] = m1 * e.y;
    T[j][2] = m2 * e.x;
    T[j][3] = m3 * e.y;
  }
  return tsum;
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
expsum_wide_kernel(const float* __restrict__ theta, const float* __restrict__ v,
                   const float* __restrict__ eta, double* __restrict__ psum,
                   float* __restrict__ dtheta, float* __restrict__ dv, int S, int B, int K, int D,
                   bool vec, bool vec_th, bool vec4) {
  extern __shared__ __align__(16) float smem[];
  float* eta_s = smem + W_RES;              // [TD], after the wide layouts
  __shared__ double red[WARPS];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int s = blockIdx.x % S;             // samples of one row tile are adjacent
  const int r0 = (blockIdx.x / S) * TB;
  const int rw = warp * 16;                 // this warp's first row in the block
  const float* th_blk = theta + ((size_t)s * B + r0) * K;
  const float* v_smp = v + (size_t)s * K * D;
  float* dv_smp = dv + (size_t)s * K * D;
  float* dth_row = dtheta + ((size_t)s * B + r0 + rw + g) * K;
  const bool row_ok = r0 + rw + g < B, row8_ok = r0 + rw + g + 8 < B;
  const auto load_eta = [&](int col0) {
    if (tid < TD / 4) load_group(eta_s + 4 * tid, eta + col0 + 4 * tid, D - col0 - 4 * tid, vec);
  };
  double rsum = 0.0;

  load_eta(0);
  // the decode takes a fresh partial a chunk (split_tf32.cuh)
  const tf32x3::WideOperands ops{smem, th_blk, v_smp, dv_smp, dth_row, B - r0, K, D,
                                 vec, vec_th, vec4, row_ok, row8_ok};
  tf32x3::wide_products<N, tf32x3::W_KSC>(
      ops, [](int) {},
      [&](int col0, float (&T)[8][4]) {
        rsum += (double)exp_cells(T, eta_s, col0, D, row_ok, row8_ok);
      },
      load_eta, [](int) {});

  // the rate total of the block, in a fixed order
  const double total = tf32x3::block_sum_fixed(rsum, red);
  if (tid == 0) psum[s * (gridDim.x / S) + blockIdx.x / S] = total;
}

inline bool aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

template <int KS>
int launch(const float* theta, const float* v, const float* eta, double* psum, float* dtheta,
           float* dv, int S, int B, int K, int D, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * smem_floats(8 * KS);
  int err = (int)cudaFuncSetAttribute(expsum_kernel<KS>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const bool vec = D % 4 == 0 && aligned(v, 16) && aligned(eta, 16);
  const bool pair = D % 2 == 0 && aligned(dv, 8);
  const int blocks = S * ((B + TB - 1) / TB);
  expsum_kernel<KS><<<blocks, THREADS, smem, stream>>>(theta, v, eta, psum, dtheta, dv, S, B,
                                                       K, D, vec, pair);
  return (int)cudaGetLastError();
}

template <int N>
int launch_wide(const float* theta, const float* v, const float* eta, double* psum,
                float* dtheta, float* dv, int S, int B, int K, int D, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * wide_smem_floats();
  int err = (int)cudaFuncSetAttribute(expsum_wide_kernel<N>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const bool vec = D % 4 == 0 && aligned(v, 16) && aligned(eta, 16);
  const bool vec_th = K % 4 == 0 && aligned(theta, 16);
  const bool vec4 = D % 4 == 0 && aligned(dv, 16);
  const int blocks = S * ((B + TB - 1) / TB);
  expsum_wide_kernel<N><<<blocks, THREADS, smem, stream>>>(theta, v, eta, psum, dtheta, dv, S, B,
                                                           K, D, vec, vec_th, vec4);
  return (int)cudaGetLastError();
}

// registers, static and dynamic shared memory and resident blocks an SM of
// a kernel at `smem` dynamic bytes, into info[0..3]
template <typename Kernel>
int kernel_info(Kernel kernel, int smem, int* info) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  return err;
}

template <int KS>
int kernel_info(int* info) {
  return kernel_info(expsum_kernel<KS>, (int)sizeof(float) * smem_floats(8 * KS), info);
}

}  // namespace

// R partials psum (S, ceil(B / 128)) float64, dtheta (S, B, K) written once,
// dv (S, K, D) added to (zeroed by the caller); K <= 64 on the instance of
// its k-steps, past that the wide kernel; K < 1 is cudaErrorInvalidValue (1).
extern "C" int poisson_expsum(const float* theta, const float* v, const float* eta,
                              double* psum, float* dtheta, float* dv, int S, int B, int K,
                              int D, void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  if (K > 8 * KS_MAX) {
    switch (padded_kc(K) / W_KC) {  // chunks: on chip to W_NRES, streamed past that
      case 3: return launch_wide<3>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
      case 4: return launch_wide<4>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
      default: return launch_wide<0>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
    }
  }
  switch ((K + 7) / 8) {
    case 1: return launch<1>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
    case 2: return launch<2>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
    case 3: return launch<3>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
    case 4: return launch<4>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
    case 5: return launch<5>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
    case 6: return launch<6>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
    case 7: return launch<7>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
    case 8: return launch<8>(theta, v, eta, psum, dtheta, dv, S, B, K, D, cs);
  }
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory a block takes at latent dimension K (the
// wrapper's launch_geometry('expsum') must agree); 0 for K < 1.
extern "C" int expsum_smem_bytes(int K) {
  if (K < 1) return 0;
  if (K > 8 * KS_MAX) return (int)sizeof(float) * wide_smem_floats();
  return (int)sizeof(float) * smem_floats((K + 7) / 8 * 8);
}

// Registers a thread, static and dynamic shared memory a block and resident
// blocks an SM (the occupancy API's) of the instance for latent dimension K,
// into info[0..3]; past K = 64 the wide kernel's.
extern "C" int expsum_kernel_info(int K, int* info) {
  if (K > 8 * KS_MAX) {
    const int smem = (int)sizeof(float) * wide_smem_floats();
    switch (padded_kc(K) / W_KC) {
      case 3: return kernel_info(expsum_wide_kernel<3>, smem, info);
      case 4: return kernel_info(expsum_wide_kernel<4>, smem, info);
      default: return kernel_info(expsum_wide_kernel<0>, smem, info);
    }
  }
  switch ((K + 7) / 8) {
    case 1: return kernel_info<1>(info);
    case 2: return kernel_info<2>(info);
    case 3: return kernel_info<3>(info);
    case 4: return kernel_info<4>(info);
    case 5: return kernel_info<5>(info);
    case 6: return kernel_info<6>(info);
    case 7: return kernel_info<7>(info);
    case 8: return kernel_info<8>(info);
  }
  return (int)cudaErrorInvalidValue;
}
