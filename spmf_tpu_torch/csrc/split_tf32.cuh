// Split-TF32 products on the tensor cores, shared by csrc/fused_expsum.cu (K5,
// whole-K and wide) and csrc/fused_poisson_wide.cu (the wide K1/K2, and the
// wide K4, which runs the decode alone: decode_step, the loads and the split
// of v), and the K-chunked machinery of their wide kernels.
//
// TF32 keeps 10 mantissa bits, too few for the tolerances these kernels are
// held to (sums 1e-5 relative, gmin 1e-6, gradients 1e-4 of their largest
// entry, against float64), so every product runs as three TF32 passes on
// split operands:
//   hi = cvt.rna.tf32.f32(x),  lo = cvt.rna.tf32.f32(x - hi),
//   a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b    (lo lo dropped, ~2^-22 a b)
// added to a float32 accumulator in that order, the small terms first. The
// tensor cores do not round their float32 accumulation to nearest, so no
// accumulator runs over more than 16 k-steps (tests/test_torch_expsum_split.py
// and tests/test_torch_stats_split.py emulate this arithmetic on the CPU).
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 fragments
// (g = lane / 4, t = lane % 4):
//   A (16 x 8, row)   a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B (8 x 8, col)    b0 (t, g)   b1 (t+4, g)
//   C (16 x 8)        c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//
// ------------------------------------------------------- the wide kernels
// Past their whole-K tiles, K5 (expsum_wide_kernel) and K1/K2
// (stats_wide_kernel) share one design. A block owns (sample s, TB = 128
// rows) and loops over the column tiles of TD = 64; 8 warps, warp w the rows
// 16w .. 16w+15 of every product that has rows; one block an SM, up to 255
// registers a thread. The decode needs the whole latent dimension before a
// cell is scored, so each column tile walks K in chunks of KC = 32 (four
// k-steps of 8): the decode over all chunks, the cells, the gradients
// chunk by chunk. What bounds it on an H100 is the three products (6 S B D K
// flops, three passes: 3.05 ms at S=8, B=4096, D=20000, K=128 against the
// data sheet's 494.7 TFLOP/s; mma.sync reaches 310-317 on an H100 at 8
// warps an SM, benchmarks/torch_tf32_rates.py) and the shared memory that feeds their
// fragments, once the device memory traffic of re-reading theta, v and
// dtheta in every column tile is gone:
//  - to padded K = 128 (N = 3 or 4 chunks; struct Resident) theta stays raw
//    in shared memory for the block's life ([TB][KPC + 4], 67,584 bytes at
//    128), the tile's v is split once into [KPC][VP] hi and lo and serves
//    both the decode and dtheta, and dtheta stays in registers (C fragments,
//    64 a thread at 128), written once at the end. The decode then needs no
//    barrier; the gradient steps split the next tile's v chunk by chunk into
//    the chunks the last step freed (two raw stages, cp.async).
//  - past that (struct Walk) each step's theta and v chunks stream through
//    two stages, v split one step ahead, and dtheta accumulates in device
//    memory by its owner thread (the block owns its rows over every column
//    tile: plain loads and stores, no atomics, the same bits on every
//    launch), its old sums loaded before the step's products.
//  - theta's A fragments are split in registers where 8 (decode) or 2 (dv)
//    n8 tiles reuse them, in integer arithmetic (split_int: cvt.rna's bits
//    at about twice its rate).
//  - decode  T_w (16 x 64) += theta_w @ v_c over the chunk's k-steps into a
//    fresh partial, added to T in float32: K5 one a chunk (4 k-steps), K1
//    one a k-step. K1's minimum is held to 1e-6 relative, and under the log
//    link its worst cells sit at rates of about 30, where a few ulps of
//    theta . v pass that: on tests/test_torch_gpu.py's wide 'mixed' inputs
//    a partial a chunk failed it on the card (the emulation of
//    tests/test_torch_stats_split.py reads 1.04e-6 there), one a k-step
//    passes (4.0e-7 emulated).
//  - cells   the kernel's own (K5: E = exp(T eta), G = E eta; K1: the
//    likelihood's d/d(theta v)), G split once into [TB][GP] hi and lo (GP =
//    68), and kept in registers as the A fragments of dtheta.
//  - dtheta  dtheta_w (16 x KC) += G_w (16 x 64) @ v_c^T: G's C fragments as
//    A fragments under the column permutation k = t <-> column 2t, k = t+4
//    <-> column 2t+1 (a0 = c0, a1 = c2, a2 = c1, a3 = c3; the B fragment
//    takes the same permutation: one float2 load), a fresh partial per 32
//    columns, the tile's two added in float32, then into the sums.
//  - dv      dv_c (KC x 64) += theta_c^T @ G over the block's 128 rows in 16
//    k-steps, one accumulator: warp w the m16 tile w % 2 of the chunk and
//    the columns 16 (w / 2) .. +15, the block's rows permuted inside each
//    k-step (k = t <-> row 2t, k = t+4 <-> row 2t + 1) in both operands, by
//    float4 atomics (red.global.add.v4.f32; lanes t and t ^ 1 trade halves
//    of their C fragments), one per element and block.
// Pitches are 4 or 8 mod 32 so that every fragment load of a warp hits 32
// distinct banks. Shared memory: W_RES floats (227,328 bytes; the streaming
// layout fits inside it) plus each kernel's cell inputs.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// ------------------------------------------------------ the split products
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three TF32 passes, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma(d, a_lo, bh0, bh1);
  mma(d, a_hi, bl0, bl1);
  mma(d, a_hi, bh0, bh1);
}

// ------------------------------------------------------- the wide kernels
// The split in integer arithmetic: on finite x the same bits as
// cvt.rna.tf32.f32 (add half of the dropped ulp to the magnitude, clear the
// 13 low bits: round to nearest, ties away from zero), at about twice its
// rate on an H100 (36.0 against 20.4 a clock and SM). The wide kernels split
// inside their product loops, where the conversion pipe was the limit.
__device__ __forceinline__ uint32_t tf32_rna_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_int(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna_int(x);
  lo = tf32_rna_int(x - __uint_as_float(hi));
}

constexpr int W_THREADS = 256;
constexpr int W_WARPS = W_THREADS / 32;
constexpr int W_TB = 128;            // rows a block owns, 16 a warp
constexpr int W_TD = 64;             // columns a tile
constexpr int W_KC = 32;             // latent dimensions a chunk
constexpr int W_KSC = W_KC / 8;      // its k-steps
constexpr int W_NRES = 4;            // to this many chunks everything stays on chip
constexpr int W_VP = W_TD + 8;       // pitch of split v [k][VP]: 8 mod 32
constexpr int W_GP = W_TD + 4;       // pitch of split G [TB][GP]: 4 mod 32
constexpr int W_VRAW = W_KC * W_TD;  // a raw v chunk [KC][TD]
constexpr int W_G = 2 * W_TB * W_GP; // G split: hi, then lo
// resident: theta [TB][KPC + 4], the tile's v split [2][KPC][VP], two raw v
// stages, G
constexpr int W_RES = W_TB * (W_NRES * W_KC + 4) + 2 * W_NRES * W_KC * W_VP + 2 * W_VRAW + W_G;
// streaming: two theta stages [TB][KC + 4], two raw v stages, two split v
// chunks [2][KC][VP], G
constexpr int W_THS = W_TB * (W_KC + 4);
constexpr int W_VHL = 2 * W_KC * W_VP;
constexpr int W_STREAM = 2 * W_THS + 2 * W_VRAW + 2 * W_VHL + W_G;

static_assert(W_WARPS * 16 == W_TB, "a warp owns 16 rows of the block");
static_assert(W_STREAM <= W_RES, "one size of shared memory serves both");
static_assert((W_VP * 4) % 16 == 0 && ((W_KC + 4) * 4) % 16 == 0, "rows on 16 bytes");

__host__ __device__ constexpr int padded_kc(int K) { return (K + W_KC - 1) / W_KC * W_KC; }

// latent k-steps of chunk c (fewer than W_KSC only in the last)
__device__ __forceinline__ int chunk_ksteps(int K, int c) {
  return min(W_KSC, ((K + 7) / 8 * 8 - c * W_KC) / 8);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four neighbouring floats of a global row into dst, of which the row still
// holds `left` (zeros for the others); vec: whole 16-byte groups
__device__ __forceinline__ void load_group(float* dst, const float* __restrict__ src, int left,
                                           bool vec) {
  if (vec) {
    if (left > 0) cp_async16(dst, src);
    else *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < left) cp_async4(dst + i, src + i);
      else dst[i] = 0.0f;
    }
  }
}

// theta's rows of the block (th_blk, `rows` of them inside B, row stride K)
// at latent dimensions k0 .. k0 + 4 kq - 1 into dst [TB][pitch], raw (zeros
// past row B and past K), by the block's NT threads
template <int NT = W_THREADS>
__device__ __forceinline__ void load_theta(float* dst, int pitch, const float* __restrict__ th_blk,
                                           int rows, int K, int k0, int kq, bool vec_th) {
  for (int p = threadIdx.x; p < W_TB * kq; p += NT) {
    const int r = p / kq, k = k0 + 4 * (p % kq);
    float* d = dst + r * pitch + (k - k0);
    if (r < rows) load_group(d, th_blk + (size_t)r * K + k, K - k, vec_th);
    else *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// v's rows kc0 .. kc0 + 31 at columns col0 .. col0 + 63 into dst [KC][TD],
// raw (zeros past K and D)
template <int NT = W_THREADS>
__device__ __forceinline__ void load_v(float* dst, const float* __restrict__ v_smp, int kc0,
                                       int col0, int K, int D, bool vec) {
  for (int p = threadIdx.x; p < W_KC * (W_TD / 4); p += NT) {
    const int j = p / (W_TD / 4), gi = p % (W_TD / 4), k = kc0 + j, c = col0 + 4 * gi;
    float* d = dst + j * W_TD + 4 * gi;
    if (k < K) load_group(d, v_smp + (size_t)k * D + c, D - c, vec);
    else *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// a raw v chunk [KC][TD] split into hi [KC][VP] and lo (lo_off floats on)
template <int NT = W_THREADS>
__device__ __forceinline__ void split_v(const float* src, float* hi, int lo_off) {
  for (int p = threadIdx.x; p < W_KC * (W_TD / 4); p += NT) {
    const int k = p / (W_TD / 4), c = 4 * (p % (W_TD / 4));
    const float4 x = *reinterpret_cast<const float4*>(src + k * W_TD + c);
    uint32_t h[4], l[4];
    split_int(x.x, h[0], l[0]);
    split_int(x.y, h[1], l[1]);
    split_int(x.z, h[2], l[2]);
    split_int(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + k * W_VP + c) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(hi + lo_off + k * W_VP + c) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// T (C fragments of the warp's 16 x 8 NJ tile, n8 tile j) += theta_w @ v_c
// over the chunk's nks k-steps, through a fresh partial every PART k-steps
// (4: one a chunk). th: the chunk's first latent dimension of the block's
// row 0, raw, rows thp floats apart (4 mod 32; A split here, once for all
// NJ n8 tiles); vh: the chunk's split v at the warp's first column, hi, lo
// vlo floats on.
template <int PART, int NJ = 8>
__device__ __forceinline__ void decode_step(const float* th, int thp, const float* vh, int vlo,
                                            int nks, int rw, float (&T)[NJ][4]) {
  static_assert(W_KSC % PART == 0, "whole partials in a chunk");
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float part[NJ][4];
#pragma unroll
  for (int ks = 0; ks < W_KSC; ++ks) {
    if (ks < nks) {
      if (ks % PART == 0) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[j][i] = 0.0f;
      }
      // a0 (g, t) = theta[rw + g][8 ks + t], a1 eight rows on, a2 / a3 four
      // latent dimensions on
      const int o = (rw + g) * thp + 8 * ks + t;
      const int off[4] = {o, o + 8 * thp, o + 4, o + 8 * thp + 4};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_int(th[off[i]], ah[i], al[i]);
      // b0 = v[8 ks + t][8 j + g], b1 four rows on
      const int ob = (8 * ks + t) * W_VP + g;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma3(part[j], ah, al, bits(vh[ob + 8 * j]), bits(vh[ob + 4 * W_VP + 8 * j]),
             bits(vh[vlo + ob + 8 * j]), bits(vh[vlo + ob + 4 * W_VP + 8 * j]));
      if (ks % PART == PART - 1 || ks == nks - 1) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) T[j][i] += part[j][i];
      }
    }
  }
}

// G (C fragments of the warp's rows) split once: hi and lo into g_s [TB][GP]
// each, and into the A fragments of dtheta's k-steps (a0 = c0, a1 = c2,
// a2 = c1, a3 = c3)
__device__ __forceinline__ void split_g(float* g_s, int rw, const float (&G)[8][4],
                                        uint32_t (&ah)[8][4], uint32_t (&al)[8][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_int(G[j][i], h[i], l[i]);
    ah[j][0] = h[0], ah[j][1] = h[2], ah[j][2] = h[1], ah[j][3] = h[3];
    al[j][0] = l[0], al[j][1] = l[2], al[j][2] = l[1], al[j][3] = l[3];
    const int o = (rw + g) * W_GP + 8 * j + 2 * t;
    *reinterpret_cast<uint2*>(g_s + o) = make_uint2(h[0], h[1]);
    *reinterpret_cast<uint2*>(g_s + o + 8 * W_GP) = make_uint2(h[2], h[3]);
    *reinterpret_cast<uint2*>(g_s + W_TB * W_GP + o) = make_uint2(l[0], l[1]);
    *reinterpret_cast<uint2*>(g_s + W_TB * W_GP + o + 8 * W_GP) = make_uint2(l[2], l[3]);
  }
}

// dsum (C fragments of dtheta_w's n8 tiles n of the chunk) = G_w @ v_c^T
// over the tile's 64 columns, a fresh partial per 32; vh as decode_step's;
// G's C fragments as A fragments under the column permutation k = t <->
// column 2t, k = t+4 <-> column 2t+1 (the B fragment takes the same
// permutation: one float2 load)
__device__ __forceinline__ void dtheta_step(const float* vh, int vlo, int nks,
                                            const uint32_t (&ah)[8][4],
                                            const uint32_t (&al)[8][4], float (&dsum)[W_KSC][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < W_KSC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dsum[n][i] = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float part[W_KSC][4];
#pragma unroll
    for (int n = 0; n < W_KSC; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[n][i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * h + jj;
#pragma unroll
      for (int n = 0; n < W_KSC; ++n) {
        if (n < nks) {
          // b0 = v[8 n + g][8 j + 2t], b1 = v[8 n + g][8 j + 2t + 1]
          const int o = (8 * n + g) * W_VP + 8 * j + 2 * t;
          const float2 hv = *reinterpret_cast<const float2*>(vh + o);
          const float2 lv = *reinterpret_cast<const float2*>(vh + vlo + o);
          mma3(part[n], ah[j], al[j], bits(hv.x), bits(hv.y), bits(lv.x), bits(lv.y));
        }
      }
    }
#pragma unroll
    for (int n = 0; n < W_KSC; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dsum[n][i] += part[n][i];
  }
}

// dv_smp[kc0 + k][col0 + c] += sum over the block's rows of theta^T G for the
// warp's m16 tile of the chunk (w % 2) and its 16 columns (16 (w / 2) ..),
// by float4 atomics (vec4: D % 4 == 0 and dv on 16 bytes, so a group lies
// inside D or past it), else float by float; past K not at all. The
// block's 16 k-steps (8 rows each) run into one accumulator; inside a
// k-step the rows are permuted (k = t <-> row 2t, k = t+4 <-> row 2t + 1) in
// both operands. th as decode_step's.
__device__ __forceinline__ void dv_step(const float* th, int thp, const float* g_s, int nks,
                                        int kc0, float* __restrict__ dv_smp, int col0, int K,
                                        int D, bool vec4) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m = warp & 1, c16 = 16 * (warp >> 1);
  if (16 * m >= 8 * nks) return;  // past the chunk's latent dimensions
  float acc[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.0f;
#pragma unroll 4
  for (int kk = 0; kk < W_TB / 8; ++kk) {
    // a0 = theta^T[16m + g][8 kk + 2t] = theta[8 kk + 2t][16m + g], a1
    // eight latent dimensions on, a2 / a3 the next row
    const int oa = (8 * kk + 2 * t) * thp + 16 * m + g;
    const int off[4] = {oa, oa + 8, oa + thp, oa + thp + 8};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_int(th[off[i]], ah[i], al[i]);
    const int ob = (8 * kk + 2 * t) * W_GP + c16 + g;  // b0 = G[8 kk + 2t][c16 + 8q + g]
#pragma unroll
    for (int q = 0; q < 2; ++q)
      mma3(acc[q], ah, al, bits(g_s[ob + 8 * q]), bits(g_s[ob + W_GP + 8 * q]),
           bits(g_s[W_TB * W_GP + ob + 8 * q]), bits(g_s[W_TB * W_GP + ob + W_GP + 8 * q]));
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    // lanes t and t ^ 1 trade halves: even t takes row g at columns 2t ..
    // 2t + 3, odd t row g + 8 at columns 2t - 2 .. 2t + 1, one float4 each
    const bool odd = t & 1;
    const float s0 = __shfl_xor_sync(0xffffffffu, odd ? acc[q][0] : acc[q][2], 1);
    const float s1 = __shfl_xor_sync(0xffffffffu, odd ? acc[q][1] : acc[q][3], 1);
    const float4 o = odd ? make_float4(s0, s1, acc[q][2], acc[q][3])
                         : make_float4(acc[q][0], acc[q][1], s0, s1);
    const int k = kc0 + 16 * m + g + (odd ? 8 : 0);
    const int c = col0 + c16 + 8 * q + 2 * (t & 2);
    if (k >= K) continue;
    float* dst = dv_smp + (size_t)k * D + c;
    if (vec4) {
      if (c < D) atomicAdd(reinterpret_cast<float4*>(dst), o);
    } else {
      const float val[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < D) atomicAdd(dst + i, val[i]);
    }
  }
}

// The warp's dtheta rows rw + g and rw + g + 8 of the block (row: the first;
// ok / ok8: they lie inside B) at latent dimensions k0 + 8n + 2t, +1 of the
// C fragments d[n], n < NN: loaded into d (zeros past B and K, and where
// `zero`), or stored (past K untouched). A block owns its rows over every
// column tile, so each element has one owner thread: plain loads and
// stores. The streaming route loads a step's old sums before its products
// and stores after them: every load is issued before any store, so their
// latency is paid once, under the products (stores through `row` and
// `row + 8 K` may alias as far as the compiler knows, so a load after a
// store waits for it).
template <int NN>
__device__ __forceinline__ void dtheta_load(const float* row, int K, bool ok, bool ok8, int k0,
                                            bool zero, float (&d)[NN][4]) {
  const int t = threadIdx.x & 3;
  const float* r8 = row + 8 * (size_t)K;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int k = k0 + 8 * n + 2 * t;
    d[n][0] = !zero && ok && k < K ? row[k] : 0.0f;
    d[n][1] = !zero && ok && k + 1 < K ? row[k + 1] : 0.0f;
    d[n][2] = !zero && ok8 && k < K ? r8[k] : 0.0f;
    d[n][3] = !zero && ok8 && k + 1 < K ? r8[k + 1] : 0.0f;
  }
}

template <int NN>
__device__ __forceinline__ void dtheta_store(float* row, int K, bool ok, bool ok8, int k0,
                                             const float (&d)[NN][4]) {
  const int t = threadIdx.x & 3;
  float* r8 = row + 8 * (size_t)K;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int k = k0 + 8 * n + 2 * t;
    if (ok && k < K) row[k] = d[n][0];
    if (ok && k + 1 < K) row[k + 1] = d[n][1];
    if (ok8 && k < K) r8[k] = d[n][2];
    if (ok8 && k + 1 < K) r8[k + 1] = d[n][3];
  }
}

// The block's float64 sum, in a fixed order (warp shuffles, then thread 0
// over the warps' sums), valid in thread 0; red: W_WARPS doubles of shared
// memory. Synchronises the block.
__device__ __forceinline__ double block_sum_fixed(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < W_WARPS; ++w) total += red[w];
  }
  return total;
}

// ------------------------------------------- resident: padded K <= 128
// The tile's v, split once, stays for the tile: vt hi [KPC][VP], lo KPC VP
// floats on. A tile runs: a barrier (the last gradient step's split of the
// tile's last chunk is whole); the decode over all chunks from theta and vt
// without barriers; the kernel's cells; N gradient steps. Gradient step c
// begins with a barrier (step c - 1's readers are done), splits the next
// tile's raw chunk c - 1 into vt and requests its raw chunk c into the raw
// stage that chunk c - 2 held; the next tile's chunk N - 1 is split at its
// top.
template <int N>
struct Resident {
  static constexpr int KPC = N * W_KC;
  static constexpr int THP = KPC + 4;        // 4 mod 32
  static constexpr int VLO = KPC * W_VP;
  float *th_s, *vt, *vraw;
  const float* v_smp;
  int K, D;
  bool vec;

  __device__ float* raw(int c) const { return vraw + (c & 1) * W_VRAW; }
  __device__ float* vchunk(int c) const { return vt + c * W_KC * W_VP; }
  // the first tile's v, chunk by chunk through stage 0 (once a block)
  __device__ void first_tile() const {
    for (int c = 0; c < N; ++c) {
      load_v(vraw, v_smp, c * W_KC, 0, K, D, vec);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      split_v(vraw, vchunk(c), VLO);
      __syncthreads();
    }
  }
  // the top of a tile at col0 > 0: the tile's chunk N - 1 split
  __device__ void top(int col0) const {
    cp_async_wait_all();
    __syncthreads();
    if (col0 > 0) split_v(raw(N - 1), vchunk(N - 1), VLO);
    __syncthreads();
  }
  // the top of gradient step c of the tile at col0: the next tile's chunk c
  // - 1 split, its chunk c requested (more: a next tile); `extra` requests
  // a kernel's own loads before the commit
  template <typename Extra>
  __device__ void grad_top(int c, int col0, bool more, Extra extra) const {
    cp_async_wait_all();
    __syncthreads();
    if (!more) return;
    if (c > 0) split_v(raw(c - 1), vchunk(c - 1), VLO);
    load_v(raw(c), v_smp, c * W_KC, col0 + W_TD, K, D, vec);
    extra();
    cp_async_commit();
  }
};

// ---------------------------------------- streaming: padded K > 128
// Step Q is chunk chunk(Q) of column tile Q / (2n), the decode for the
// first n steps of a tile, the gradients (chunks n-1 .. 0) for the next n.
// At the top of step Q (one barrier): step Q + 1's theta chunk and step Q +
// 2's raw v chunk are requested into the stages step Q - 1 freed, step Q +
// 1's v split into the other split buffer; two stages of each.
struct Walk {
  float *th_s, *vraw, *vhl;      // theta stages, raw v stages, split v buffers
  const float* th_blk;           // theta's first row of the block
  const float* v_smp;            // v (K, D) of the block's sample
  int rows, K, D, n, total;      // rows of the block inside B; chunks; steps
  bool vec, vec_th;              // 16-byte groups of v rows and of theta rows

  __device__ int chunk(int Q) const {
    const int q = Q % (2 * n);
    return q < n ? q : 2 * n - 1 - q;
  }
  __device__ int col(int Q) const { return Q / (2 * n) * W_TD; }
  __device__ const float* th(int Q) const { return th_s + (Q & 1) * W_THS; }
  __device__ float* vh(int Q) const { return vhl + (Q & 1) * W_VHL; }
  __device__ void load_th(int Q) const {
    load_theta(th_s + (Q & 1) * W_THS, W_KC + 4, th_blk, rows, K, chunk(Q) * W_KC, W_KC / 4,
               vec_th);
  }
  __device__ void load_vq(int Q) const {
    load_v(vraw + (Q & 1) * W_VRAW, v_smp, chunk(Q) * W_KC, col(Q), K, D, vec);
  }
  __device__ void split_vq(int Q) const { split_v(vraw + (Q & 1) * W_VRAW, vh(Q), W_KC * W_VP); }

  // before step 0: its chunk in and its v split, step 1's raw v requested
  __device__ void start() const {
    load_th(0);
    load_vq(0);
    if (total > 1) load_vq(1);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    split_vq(0);
  }
  // the top of step Q; `extra` requests a kernel's own loads before the
  // commit
  template <typename Extra>
  __device__ void begin(int Q, Extra extra) const {
    cp_async_wait_all();
    __syncthreads();
    if (Q + 1 < total) load_th(Q + 1);
    if (Q + 2 < total) load_vq(Q + 2);
    extra();
    cp_async_commit();
    if (Q + 1 < total) split_vq(Q + 1);
  }
};

// ------------------------------------------------- the loop of both kernels
// What a wide kernel hands wide_products: its block's operands.
struct WideOperands {
  float* smem;               // W_RES floats (the layouts above; G last)
  const float* th_blk;       // theta's first row of the block
  const float* v_smp;        // v (K, D) of the block's sample
  float* dv_smp;             // dv (K, D) of the block's sample, added to
  float* dth_row;            // dtheta's row rw + g of the block (the thread's first)
  int rows, K, D;            // rows of the block inside B
  bool vec, vec_th, vec4;    // 16-byte groups: v rows, theta rows, dv
  bool row_ok, row8_ok;      // rows rw + g and rw + g + 8 inside B
};

// A wide kernel's block over its column tiles: per tile the decode over all
// chunks (a fresh partial every PART k-steps), the kernel's cells, G split
// once, then dtheta and dv chunk by chunk; dtheta written whole. N > 0: the
// resident layout of N chunks; N = 0: the streaming one. The kernel's own
// steps: tile_loads(col0) requests the tile's own inputs under its decode
// (committed with the chunks'); cells(col0, T) turns the decode sums T into
// G in place (what it waits for, its warp loaded); next_loads(col1)
// requests the next tile's own inputs at the first gradient step, after its
// barrier (every warp's cells are done), and grads_begin(col0) runs there
// too.
template <int N, int PART, typename TileLoads, typename Cells, typename NextLoads,
          typename GradsBegin>
__device__ __forceinline__ void wide_products(const WideOperands& o, TileLoads tile_loads,
                                              Cells cells, NextLoads next_loads,
                                              GradsBegin grads_begin) {
  const int rw = (threadIdx.x >> 5) * 16;
  float* g_s = o.smem + W_RES - W_G;
  uint32_t ah[8][4], al[8][4];
  float T[8][4];
  if constexpr (N > 0) {
    using R = Resident<N>;
    const int th_floats = W_TB * (W_NRES * W_KC + 4);
    const R res{o.smem, o.smem + th_floats, o.smem + th_floats + 2 * W_NRES * W_KC * W_VP,
                o.v_smp, o.K, o.D, o.vec};
    load_theta(res.th_s, R::THP, o.th_blk, o.rows, o.K, 0, R::KPC / 4, o.vec_th);
    res.first_tile();
    float dth[W_KSC * N][4];
#pragma unroll
    for (int m = 0; m < W_KSC * N; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) dth[m][i] = 0.0f;
    for (int col0 = 0; col0 < o.D; col0 += W_TD) {
      const bool more = col0 + W_TD < o.D;
      res.top(col0);
      tile_loads(col0);
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) T[j][i] = 0.0f;
#pragma unroll 1
      for (int c = 0; c < N; ++c)  // rolled: the decode holds no dtheta
        decode_step<PART>(res.th_s + c * W_KC, R::THP, res.vchunk(c), R::VLO,
                          chunk_ksteps(o.K, c), rw, T);
      cells(col0, T);
      split_g(g_s, rw, T, ah, al);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        // every warp's G is in g_s
        res.grad_top(c, col0, more, [&] {
          if (c == 0) next_loads(col0 + W_TD);
        });
        if (c == 0) grads_begin(col0);
        const int nks = chunk_ksteps(o.K, c);
        float dsum[W_KSC][4];
        dtheta_step(res.vchunk(c), R::VLO, nks, ah, al, dsum);
#pragma unroll
        for (int m = 0; m < W_KSC; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) dth[W_KSC * c + m][i] += dsum[m][i];
        dv_step(res.th_s + c * W_KC, R::THP, g_s, nks, c * W_KC, o.dv_smp, col0, o.K, o.D,
                o.vec4);
      }
    }
    dtheta_store(o.dth_row, o.K, o.row_ok, o.row8_ok, 0, dth);
  } else {
    const int n = padded_kc(o.K) / W_KC;
    const Walk walk{o.smem, o.smem + 2 * W_THS, o.smem + 2 * W_THS + 2 * W_VRAW, o.th_blk,
                    o.v_smp, o.rows, o.K, o.D, n, 2 * n * ((o.D + W_TD - 1) / W_TD), o.vec,
                    o.vec_th};
    walk.start();
    int Q = 0;
    for (int col0 = 0; col0 < o.D; col0 += W_TD) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) T[j][i] = 0.0f;
      for (int q = 0; q < n; ++q, ++Q) {
        // at the tile's first step g_s is free: the last tile's readers are
        // done
        walk.begin(Q, [&] {
          if (q == 0) tile_loads(col0);
        });
        decode_step<PART>(walk.th(Q), W_KC + 4, walk.vh(Q), W_KC * W_VP, chunk_ksteps(o.K, q),
                          rw, T);
      }
      cells(col0, T);
      split_g(g_s, rw, T, ah, al);
      const bool first = col0 == 0;
      for (int q = n; q < 2 * n; ++q, ++Q) {
        walk.begin(Q, [&] {
          if (q == n && col0 + W_TD < o.D) next_loads(col0 + W_TD);
        });
        if (q == n) grads_begin(col0);
        const int c = walk.chunk(Q), nks = chunk_ksteps(o.K, c);
        float old[W_KSC][4], dsum[W_KSC][4];
        dtheta_load(o.dth_row, o.K, o.row_ok, o.row8_ok, c * W_KC, first, old);
        dtheta_step(walk.vh(Q), W_KC * W_VP, nks, ah, al, dsum);
        dv_step(walk.th(Q), W_KC + 4, g_s, nks, c * W_KC, o.dv_smp, col0, o.K, o.D, o.vec4);
#pragma unroll
        for (int m = 0; m < W_KSC; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) old[m][i] += dsum[m][i];
        dtheta_store(o.dth_row, o.K, o.row_ok, o.row8_ok, c * W_KC, old);
      }
    }
  }
}

}  // namespace tf32x3
